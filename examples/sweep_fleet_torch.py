"""Fleet sweep example on the PyTorch / CUDA port (the counterpart of
`examples/sweep_fleet.py`): batched multi-trace / multi-seed simulation.

Runs a small parameter sweep — 3 traces x 2 seeds x {baseline, ips_agc}
x both modes, plus a cache-size sensitivity row — as ONE `ssd_step`
launch on the card, then prints baseline-normalized results and writes a
`BENCH_torch_example_sweep.json` artifact through the port's store
(never the reference's `BENCH_example_sweep.json`).

`--devices N` runs N ranks of one process group, each its slice of the
cells, as `python -m repro_torch.sweep.cli --devices N` does: ranks that
share one card (gloo). Its default is 1, where the reference's is the
host's core count: there each device is an XLA host device, here a rank
is a process with its own CUDA context on the same card, so more ranks
add start-up time and no compute.

Run: PYTHONPATH=src python examples/sweep_fleet_torch.py [--devices N] \\
         [--max-ops N] [--device cpu]

For the full paper figure set use the CLI:
    PYTHONPATH=src python -m repro_torch.sweep.cli --grid paper
"""
import argparse
import sys

import torch

from repro_torch.configs.ssd_paper import PAPER_SSD
from repro_torch.distributed import group as dgroup
from repro_torch.sweep import expand_grid, save_bench
from repro_torch.sweep.report import normalize_points, policy_geomeans
from repro_torch.sweep.runner import run_sweep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks sharing the card, each its slice of the "
                         "cells")
    ap.add_argument("--max-ops", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel) or cpu (its plain version)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (use --device cpu "
                         "for the kernel's plain version)")
    if args.devices < 1:
        raise SystemExit("--devices wants 1 or more ranks")
    if args.devices > 1 and dgroup.world_size() == 1:
        # each rank loads this file: it need not be importable by name
        return dgroup.spawn_script(
            __file__, args.devices, sys.argv[1:] if argv is None else argv,
            device=args.device)[0]

    cfg = PAPER_SSD.scaled(128)
    points = expand_grid(traces=("hm_0", "stg_0", "prxy_0"),
                         policies=("baseline", "ips_agc"),
                         seeds=(0, 1))
    # cache-size sensitivity: same cells at half / double SLC cache —
    # per-cell parameters, so the same launch
    points += expand_grid(traces=("hm_0",), modes=("daily",),
                          policies=("baseline", "ips_agc"),
                          cache_fracs=(0.5, 2.0))

    print(f"{len(points)} cells ...")
    results = run_sweep(cfg, points, max_ops=args.max_ops,
                        device=args.device,
                        progress=lambda s: print(f"  {s}"))

    lat = normalize_points(results, "mean_write_latency_ms")
    wa = normalize_points(results, "wa_paper")
    print(f"\n{'cell':<42}{'lat/base':>9}{'wa/base':>9}")
    for pt in sorted(lat, key=lambda p: p.key):
        print(f"{pt.key:<42}{lat[pt]:>9.3f}{wa[pt]:>9.3f}")
    print("\ngeomeans (unqualified cells):")
    for (mode, policy), v in sorted(policy_geomeans(results).items()):
        print(f"  {mode:>7} {policy:<8} lat={v['mean_write_latency_ms']:.3f}"
              f" wa={v['wa_paper']:.3f}")

    if dgroup.rank() == 0:
        path = save_bench("example_sweep", {"results": results}, cfg=cfg,
                          device=args.device)
        print(f"\nwrote {path}")
    return results


if __name__ == "__main__":
    main()
