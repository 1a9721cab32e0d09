"""Time the `ssd_step` kernel's paper-grid launch on the card, with the
telemetry probe off and on, for one checkout of the port or for two side
by side.

    python src/repro_torch/kernels/ssd_step/bench.py [--src DIR]
        [--label NAME] [--reps 5] [--window 1024]

`--src` names the `src/` directory whose `repro_torch` is timed (default:
this checkout's), so a parent commit unpacked beside the change is timed
by the same code: run parent, change, change, parent in one call. Each
rep runs the uncut `paper` grid (102 cells) through
`sweep.runner.run_sweep` on the card, ONE launch, its traces from the
trace cache under `$REPRO_TORCH_TRACE_CACHE_DIR` (one warm-up run first),
and reads the launch's CUDA events and the longest cell's clock64
cycles per stepped op from the kernel's block timers; the probe-on reps
(`timeline_ops=--window`) run where the checkout has the probe. Probe
off and on alternate within a rep. Prints one JSON line with the
medians and every rep, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else "nvidia-smi: no output"


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(here, "..", "..", ".."),
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--window", type=int, default=1024)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("bench: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.ssd_paper import PAPER_SSD
    from repro_torch.kernels.ssd_step import ops as ssd_step
    from repro_torch.sweep.grid import named_grid
    from repro_torch.sweep.runner import run_sweep
    from repro_torch.workloads import TraceCache

    cfg = PAPER_SSD.scaled(128)
    cuda = torch.device("cuda", 0)
    points = named_grid("paper")
    cache = TraceCache()
    has_probe = "timeline_ops" in inspect.signature(run_sweep).parameters
    ssd_step.LIB.load()

    def one(window):
        timings = []
        kw = {} if window is None else {"timeline_ops": window}
        run_sweep(cfg, points, device=cuda, timings=timings,
                  trace_cache=cache, **kw)
        torch.cuda.synchronize()
        longest = max(timings, key=lambda g: g["max_cell_ops"])
        return {"launch_ms": timings[0]["launch_ms"],
                "cycles_per_op": longest["cycles"] / longest["max_cell_ops"],
                "ns_per_op": longest["ns_per_op"]}

    one(None)                                      # warm-up
    runs = {"off": [], "on": []}
    for _ in range(args.reps):
        runs["off"].append(one(None))
        if has_probe:
            runs["on"].append(one(args.window))

    def med(rows, key):
        return statistics.median(r[key] for r in rows) if rows else None

    out = {"bench": "ssd_step_paper_grid", "label": args.label,
           "src": os.path.abspath(args.src), "card": _card(),
           "reps": args.reps, "window_ops": args.window if has_probe
           else None, "build_s": ssd_step.LIB.build_s, **ssd_step.LIB.ptxas()}
    for side in ("off", "on"):
        for key in ("launch_ms", "cycles_per_op", "ns_per_op"):
            out[f"{side}_{key}"] = med(runs[side], key)
    out["runs"] = runs
    print(json.dumps(out, sort_keys=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
