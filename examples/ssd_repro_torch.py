"""Reproduce the paper's headline results (Figs. 9-12) on the scaled
drive, on the PyTorch / CUDA port (the counterpart of
`examples/ssd_repro.py`).

Prints the full normalized table: write latency and write amplification
of IPS / IPS-agc / cooperative vs the Turbo-Write baseline, bursty and
daily. Every cell runs on the batched fleet path
(`driver.eval_matrix` -> one `ssd_step` launch for all 88 cells on the
card; the kernel's plain version on the CPU).

Run: PYTHONPATH=src python examples/ssd_repro_torch.py \\
         [--workloads hm_0,stg_0] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.ssd_paper import PAPER_SSD
from repro_torch.core.ssd.driver import DEFAULT_SCALE, eval_matrix
from repro_torch.core.ssd.workloads import TRACE_NAMES

POLICIES = ("baseline", "ips", "ips_agc", "coop")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workloads", default=",".join(TRACE_NAMES))
    ap.add_argument("--scale", type=int, default=DEFAULT_SCALE)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel) or cpu (its plain version)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (use --device cpu "
                         "for the kernel's plain version)")
    names = args.workloads.split(",")
    cfg = PAPER_SSD.scaled(args.scale)
    print(f"simulated SSD: {cfg.capacity_gb:.1f} GB (1/{args.scale} of the "
          f"paper's 384 GB), SLC cache {cfg.slc_cap_pages*cfg.num_planes} "
          f"pages")

    results = eval_matrix(cfg, policies=POLICIES, names=names,
                          device=args.device)

    agg = {}
    for mode in ("bursty", "daily"):
        print(f"\n=== {mode} (normalized to baseline) ===")
        print(f"{'workload':<9}" + "".join(
            f"{p+' lat':>12}{p+' wa':>10}" for p in ("ips", "agc", "coop")))
        for name in names:
            base = results[f"{name}/{mode}/baseline"]
            row = f"{name:<9}"
            for policy in ("ips", "ips_agc", "coop"):
                r = results[f"{name}/{mode}/{policy}"]
                nl = (r["mean_write_latency_ms"]
                      / base["mean_write_latency_ms"])
                nw = r["wa_paper"] / base["wa_paper"]
                agg.setdefault((mode, policy), []).append((nl, nw))
                row += f"{nl:>12.2f}{nw:>10.2f}"
            print(row)
    print("\n=== means (paper targets in brackets) ===")
    paper = {("bursty", "ips"): "0.77/1.0", ("daily", "ips"): "1.3/0.53",
             ("daily", "ips_agc"): "0.75/0.59",
             ("daily", "coop"): "0.78/0.67"}
    for (mode, policy), vals in agg.items():
        lat = np.mean([v[0] for v in vals])
        wa = np.mean([v[1] for v in vals])
        tgt = paper.get((mode, policy), "-")
        print(f"{mode:>7} {policy:<8} lat={lat:.2f} wa={wa:.2f}   [{tgt}]")
    return results


if __name__ == "__main__":
    main()
