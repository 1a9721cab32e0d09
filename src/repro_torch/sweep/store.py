"""`BENCH_torch_*.json` result store: sweep results and run metadata on
disk.

Copy of the reference package's `sweep/store.py` (`save_bench`,
`load_bench`, `list_benches`, and the artifact checks
`check_step_throughput` and `check_hostcache_sweep`, which accept the
port's documents and the reference's alike), writing only the port's
own names: a
bench named `sweep_paper` lands in `BENCH_torch_sweep_paper.json`, never
in the reference's `BENCH_sweep_paper.json`. Each file carries enough
metadata (git SHA, torch and CUDA versions, the device, the config) to
compare runs between commits. Writes are atomic (temp file + rename), so
concurrent writers each land a complete document.
"""
from __future__ import annotations

import json
import os
import platform
import subprocess
import tempfile
import time
from typing import Dict, Optional

__all__ = ["save_bench", "load_bench", "list_benches", "bench_name",
           "check_step_throughput", "check_hostcache_sweep", "PREFIX"]

SCHEMA_VERSION = 1
PREFIX = "torch_"


def bench_name(name: str) -> str:
    """The port's artifact name for `name`: always `torch_`-prefixed."""
    return name if name.startswith(PREFIX) else PREFIX + name


def _git_sha() -> Optional[str]:
    """Best-effort commit SHA of the working tree (None outside a repo or
    without git) — ties every artifact to the code that produced it."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5)
    except (OSError, subprocess.TimeoutExpired):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def _run_meta(device=None) -> Dict:
    import torch
    meta = {
        "schema_version": SCHEMA_VERSION,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "git_sha": _git_sha(),
        "torch_version": torch.__version__,
        "cpu_count": os.cpu_count(),
        "platform": platform.platform(),
    }
    if device is not None:
        meta["device"] = str(device)
        if torch.device(device).type == "cuda":
            meta["device_name"] = torch.cuda.get_device_name(device)
            meta["device_count"] = torch.cuda.device_count()
            meta["cuda_version"] = torch.version.cuda
    return meta


def _point_key(k) -> str:
    return k if isinstance(k, str) else k.key


def save_bench(name: str, payload: Dict, *, directory: str = ".",
               cfg=None, device=None,
               extra_meta: Optional[Dict] = None) -> str:
    """Write `BENCH_torch_<name>.json` and return its path.

    payload["results"] may be keyed by SweepPoint (serialized via .key) or
    by string; everything else must already be JSON-compatible."""
    name = bench_name(name)
    doc = {"name": name, "meta": _run_meta(device)}
    if cfg is not None:
        import dataclasses
        doc["config"] = dataclasses.asdict(cfg)
    if extra_meta:
        doc["meta"].update(extra_meta)
    payload = dict(payload)
    if "results" in payload:
        payload["results"] = {_point_key(k): v
                              for k, v in payload["results"].items()}
    doc.update(payload)
    path = os.path.join(directory, f"BENCH_{name}.json")
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=f".BENCH_{name}.",
                               suffix=".tmp")
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
    return path


def check_step_throughput(doc: Dict, *, min_speedup: float = 0.0) -> Dict:
    """Validate a step-throughput document — the port's
    `BENCH_torch_step_throughput.json` (scripts/bench_step_torch.py) or
    the reference's `BENCH_step_throughput.json` — and return it.
    Raises AssertionError on a malformed artifact; `min_speedup`
    additionally gates the geomean compressed-vs-per-op speedup (the CI
    throughput floor)."""
    assert doc.get("meta", {}).get("git_sha") is not None or \
        "git_sha" in doc.get("meta", {}), "missing meta"
    assert doc.get("policy") and doc.get("mode"), "missing policy/mode"
    traces = doc.get("traces")
    assert traces, "no per-trace rows"
    for name, row in traces.items():
        assert {"t_len", "t_trim", "fill"} <= set(row), (name, row.keys())
        for path in ("per_op", "compressed", "packed"):
            r = row[path]
            assert r["warm_s"] > 0 and r["ops_per_s"] > 0, (name, path, r)
        assert row["speedup_compressed"] > 0, name
        assert row["speedup_packed"] > 0, name
    gm = doc.get("geomean_speedup", {})
    assert {"compressed", "packed"} <= set(gm), gm
    if min_speedup:
        assert gm["compressed"] >= min_speedup, (
            f"step throughput gate: compressed geomean speedup "
            f"{gm['compressed']:.2f}x < required {min_speedup:.2f}x")
    return doc


def check_hostcache_sweep(doc: Dict) -> Dict:
    """Validate a `hostcache` grid document — the port's
    `BENCH_torch_sweep_hostcache.json` or the reference's
    `BENCH_sweep_hostcache.json` (DESIGN.md §14) — and return it. Raises
    AssertionError on a malformed artifact:

    * results must carry both host-tier cells (`&...hc=` qualified keys
      with the host_* columns) and their device-only references;
    * a `hostcache` summary block with the per-(mode, policy, tag)
      columns, every entry paired against an off cell (`lat_vs_off` set);
    * every write-back row must absorb write traffic (device-visible
      writes strictly below trace writes); daily write-back rows must
      additionally show a host hit rate above zero. (Bursty mode's
      sequential-rewrite transform has no address reuse by construction,
      so bursty hit rates are legitimately zero — absorption there is
      pure write-allocation.)
    """
    results = doc.get("results")
    assert results, "no results"
    on = {k: v for k, v in results.items() if "hc=" in k}
    off = {k: v for k, v in results.items() if "hc=" not in k}
    assert on and off, "need host-tier cells AND device-only references"
    host_cols = {"host_hit_rate", "host_dev_write_frac", "host_absorbed",
                 "host_flush_w", "host_evict_w"}
    for key, row in on.items():
        assert host_cols <= set(row), (key, sorted(row))
    for key, row in off.items():
        assert not (host_cols & set(row)), (
            f"device-only cell {key} grew host columns")
    hc = doc.get("hostcache")
    assert hc, "missing hostcache summary block"
    for key, v in hc.items():
        assert {"host_hit_rate", "host_dev_write_frac", "lat_vs_off",
                "wa_vs_off", "n"} <= set(v), (key, sorted(v))
        assert v["lat_vs_off"] is not None, (
            f"{key}: no device-only reference cell to normalize against")
        if "/wb" in key:
            assert v["host_dev_write_frac"] < 1.0, (
                f"{key}: write-back absorbed no write traffic")
            if key.startswith("daily/"):
                assert v["host_hit_rate"] > 0, (
                    f"{key}: write-back host tier never hit")
    return doc


def load_bench(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def list_benches(directory: str = ".") -> Dict[str, Dict]:
    """Every `BENCH_torch_*.json` in a directory, keyed by bench name
    (the reference's `BENCH_*.json` files are not the port's)."""
    out = {}
    for fn in sorted(os.listdir(directory)):
        if fn.startswith("BENCH_" + PREFIX) and fn.endswith(".json"):
            try:
                doc = load_bench(os.path.join(directory, fn))
            except (json.JSONDecodeError, OSError):
                continue
            out[doc.get("name", fn[6:-5])] = doc
    return out
