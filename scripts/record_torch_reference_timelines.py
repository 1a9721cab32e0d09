"""Record the reference's windowed timelines of the uncut paper grid,
for the PyTorch port's check on the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/record_torch_reference_timelines.py \
        [--out tests/data/torch_reference_timelines.json] [--devices 2]

Runs the reference package's `repro.sweep.runner.run_sweep` on the
`paper` grid (102 cells, uncut) with the in-scan probe on at 1024 ops a
window, live on the CPU, and writes per cell: the `detect_cliff` dict
of `telemetry.timeline.series`, the float64 totals of `lat_sum`,
`occ_sum` and `idle_ms`, and a sha256 of the float32 bytes of each
series the port must reproduce exactly (`ops`, `writes`, `lat_hist`,
`ctr`, `t_last`); for the `hm_0` cells the three float series in full.
`chip_smoke.py` holds the port's timelines to this file.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

WINDOW_OPS = 1024
EXACT = ("ops", "writes", "lat_hist", "ctr", "t_last")
FLOATS = ("lat_sum", "occ_sum", "idle_ms")


def digest(x) -> str:
    import numpy as np
    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(x, np.float32)).tobytes()).hexdigest()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        "tests", "data", "torch_reference_timelines.json"))
    ap.add_argument("--devices", type=int, default=2)
    args = ap.parse_args(argv)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_"
                               f"force_host_platform_device_count="
                               f"{args.devices}").strip()
    import jax
    import numpy as np

    from repro import workloads
    from repro.configs.ssd_paper import PAPER_SSD
    from repro.sweep.grid import named_grid
    from repro.sweep.runner import run_sweep
    from repro.telemetry import timeline as tmod

    cfg = PAPER_SSD.scaled(128)
    points = named_grid("paper")
    timelines = {}
    run_sweep(cfg, points, timeline_ops=WINDOW_OPS, timelines=timelines,
              trace_cache=workloads.TraceCache(use_disk=False))
    cells = {}
    for pt in sorted(points, key=lambda p: p.key):
        tl = timelines[pt]
        cell = {"n_windows": int(np.asarray(tl["ops"]).shape[0]),
                "cliff": tmod.series(tl)["cliff"],
                "totals": {k: float(np.sum(np.asarray(tl[k], np.float64)))
                           for k in FLOATS},
                "sha256": {k: digest(tl[k]) for k in EXACT}}
        if pt.trace == "hm_0":
            cell["series"] = {k: [float(v) for v in np.asarray(tl[k])]
                              for k in FLOATS}
        cells[pt.key] = cell
    doc = {"description": "Windowed timelines of the reference package's "
                          "paper grid, run live on the CPU, uncut; the "
                          "port's chip_smoke.py holds its probe to them.",
           "command": "PYTHONPATH=src JAX_PLATFORMS=cpu python "
                      "scripts/record_torch_reference_timelines.py "
                      f"--devices {args.devices}",
           "jax_version": jax.__version__, "backend": "cpu",
           "grid": "paper", "cut": "uncut", "window_ops": WINDOW_OPS,
           "exact": list(EXACT), "floats": list(FLOATS),
           "n_cells": len(cells), "cells": cells}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {args.out}: {len(cells)} cells, "
          f"{os.path.getsize(args.out)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
