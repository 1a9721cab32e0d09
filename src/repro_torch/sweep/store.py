"""`BENCH_torch_*.json` result store: sweep results and run metadata on
disk.

Copy of the reference package's `sweep/store.py` (`save_bench`,
`load_bench`, `list_benches`), writing only the port's own names: a
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
           "PREFIX"]

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
