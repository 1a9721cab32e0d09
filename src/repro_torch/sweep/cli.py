"""Sweep CLI of the port: `python -m repro_torch.sweep.cli --grid paper`
runs the paper's evaluation grid (Figs. 9-12) through the fleet
simulator and writes `BENCH_torch_sweep_<grid>.json` into `--out-dir`.

  python -m repro_torch.sweep.cli --grid paper              # on the card
  python -m repro_torch.sweep.cli --grid quick --device cpu --max-ops 2048

Every artifact it writes is named `BENCH_torch_*.json`, so it never
overwrites a file of the reference package. On the CPU the fleet runs
the kernel's plain version, an op at a time in Python: keep `--max-ops`
small there.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import platform
import sys
import time

from repro_torch.sweep.grid import GRIDS

__all__ = ["main"]


def _parse(argv):
    ap = argparse.ArgumentParser(
        prog="repro_torch.sweep.cli",
        description="Batched sweeps over the hybrid-SSD fleet simulator "
                    "(paper Figs. 9-12), PyTorch / CUDA port.")
    ap.add_argument("--grid", choices=tuple(GRIDS), default="paper")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                    "kernel's plain version)")
    ap.add_argument("--max-ops", type=int, default=None,
                    help="truncate traces (smoke runs)")
    ap.add_argument("--out-dir", default=".",
                    help="where BENCH_torch_sweep_<grid>.json is written")
    ap.add_argument("--no-save", action="store_true")
    return ap.parse_args(argv)


def _device_meta(device) -> dict:
    import torch
    meta = {"torch_version": torch.__version__, "device": str(device),
            "platform": platform.platform(),
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S")}
    if torch.device(device).type == "cuda":
        meta["device_name"] = torch.cuda.get_device_name(device)
        meta["device_count"] = torch.cuda.device_count()
        meta["cuda_version"] = torch.version.cuda
    return meta


def main(argv=None) -> int:
    args = _parse(argv if argv is not None else sys.argv[1:])
    import torch

    from repro_torch.configs.ssd_paper import PAPER_SSD
    from repro_torch.core.ssd.driver import DEFAULT_SCALE
    from repro_torch.sweep.grid import named_grid
    from repro_torch.sweep.report import policy_geomeans, throughput_table
    from repro_torch.sweep.runner import run_sweep

    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is available; "
              "pass --device cpu for the plain version", file=sys.stderr)
        return 2
    cfg = PAPER_SSD.scaled(DEFAULT_SCALE)
    points = named_grid(args.grid)
    print(f"sweep: {len(points)} cells on a 1/{DEFAULT_SCALE} drive "
          f"({cfg.capacity_gb:.1f} GB) on {args.device}")
    timings = []
    t0 = time.perf_counter()
    results = run_sweep(cfg, points, max_ops=args.max_ops,
                        device=args.device, timings=timings,
                        progress=lambda s: print(f"  {s}"))
    wall = time.perf_counter() - t0
    padded = sum(g["cells"] * g["t_len"] for g in timings)
    throughput = {"wall_s": wall, "ops_per_s": padded / max(wall, 1e-9),
                  "cells_per_s": len(points) / max(wall, 1e-9)}
    print(f"  {len(timings)} group(s) in {wall:.3f} s: "
          f"{throughput['ops_per_s'] / 1e6:.3f} Mops/s over the padded "
          "length")
    print(throughput_table(timings))
    geomeans = {f"{m}/{p}": v for (m, p), v in
                sorted(policy_geomeans(results).items())}
    print("\n=== geomeans vs declared baseline ===")
    for key, v in geomeans.items():
        print(f"{key:<16} lat={v.get('mean_write_latency_ms', float('nan')):.4f}"
              f" wa={v.get('wa_paper', float('nan')):.4f}  (n={v['n']})")
    if not args.no_save:
        name = f"torch_sweep_{args.grid}"
        doc = {"name": name, "meta": _device_meta(args.device),
               "config": dataclasses.asdict(cfg), "grid": args.grid,
               "n_cells": len(points), "max_ops": args.max_ops,
               "scale": DEFAULT_SCALE, "group_timings": timings,
               "throughput": throughput,
               "results": {pt.key: v for pt, v in sorted(
                   results.items(), key=lambda kv: kv[0].key)},
               "geomeans": geomeans}
        os.makedirs(args.out_dir, exist_ok=True)
        path = os.path.join(args.out_dir, f"BENCH_{name}.json")
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        print(f"\nwrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
