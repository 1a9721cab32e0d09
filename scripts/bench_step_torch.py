#!/usr/bin/env python
"""Single-cell step-engine throughput of the PyTorch / CUDA port: the
counterpart of `scripts/bench_step.py` for `repro_torch`.

Times the three step-engine paths warm over the daily MSR traces, one
cell at a time (on a card each call is one `ssd_step` launch; on the CPU
the kernel's plain version, an op at a time):

  per_op     — the per-op stream (`sim.run_trace`: the live prefix
               scanned, the pad tail replayed to its fixed point)
  compressed — the event-compressed segment stream (`sim.run_compressed`)
  packed     — the same with the int16-packed carry

Ops/s always credits the ORIGINAL padded length T, as the reference's
script does, so pad-tail trimming shows up as throughput rather than as
shrunk work; the speedup column is the wall-clock ratio on identical
(bit-identical) simulations. Each timing ends in a device synchronize.

Writes `BENCH_torch_step_throughput.json` through the port's
`sweep.store.save_bench` (never the reference's
`BENCH_step_throughput.json`), validates it with the port's
`check_step_throughput` (`--min-speedup` gates the compressed geomean),
and appends one record to `BENCH_torch_history.json`. Each per-trace
timing is a `telemetry.spans` span (`--chrome-trace` exports the tree).

Usage:
  PYTHONPATH=src python scripts/bench_step_torch.py            # 11 traces
  PYTHONPATH=src python scripts/bench_step_torch.py \\
      --traces hm_0,proj_0 --max-ops 32768 --out-dir build
  PYTHONPATH=src python scripts/bench_step_torch.py --device cpu \\
      --traces hm_0 --max-ops 64 --no-save
"""
from __future__ import annotations

import argparse
import json
import time


def _time_warm(fn, reps: int) -> float:
    fn()                                   # build + warm
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traces", default=None,
                    help="comma-separated MSR trace names (default: all)")
    ap.add_argument("--policy", default="ips_agc")
    ap.add_argument("--mode", default="daily", choices=("daily", "bursty"))
    ap.add_argument("--max-ops", type=int, default=None,
                    help="truncate traces (smoke runs)")
    ap.add_argument("--scale", type=int, default=128)
    ap.add_argument("--reps", type=int, default=1,
                    help="timed repetitions after warmup")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernel) or cpu (its plain "
                    "version)")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--min-speedup", type=float, default=0.0,
                    help="fail unless compressed geomean speedup >= this")
    ap.add_argument("--chrome-trace", default=None, metavar="PATH",
                    help="export the run's span tree as a Chrome "
                    "trace-event file")
    ap.add_argument("--no-history", action="store_true",
                    help="skip the BENCH_torch_history.json append")
    args = ap.parse_args(argv)

    import torch

    import repro_torch.workloads as wl
    from repro_torch.configs.ssd_paper import PAPER_SSD
    from repro_torch.core.ssd import sim
    from repro_torch.core.ssd.policies.registry import resolve_spec
    from repro_torch.core.ssd.policies.state import can_pack, default_cell
    from repro_torch.sweep.report import geomean
    from repro_torch.sweep.runner import _n_logical
    from repro_torch.sweep.store import (_git_sha, check_step_throughput,
                                         save_bench)
    from repro_torch.telemetry import Tracer, chrome_trace
    from repro_torch.telemetry.spans import span
    from repro_torch.workloads.compress import compress_ops

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to time the "
                         "plain version")
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    cfg = PAPER_SSD.scaled(args.scale)
    n_logical, capacity = _n_logical(cfg), cfg.total_pages
    closed = args.mode == "bursty"
    names = (args.traces.split(",") if args.traces
             else list(wl.TRACE_NAMES))
    params = default_cell(cfg, resolve_spec(args.policy), device=device)

    tracer = Tracer()
    traces = {}
    with tracer.activate():
        for name in names:
            ops = wl.build_ops(name, n_logical, mode=args.mode,
                               capacity_pages=capacity)
            if args.max_ops:
                ops = wl.truncate_trace(ops, args.max_ops)
            t_len = int(ops["arrival_ms"].shape[0])
            comp = compress_ops(ops)

            def per_op():
                sim.run_trace(cfg, args.policy, ops, closed_loop=closed,
                              n_logical=n_logical, params=params,
                              device=device)
                sync()

            def compressed(packed=False):
                sim.run_compressed(cfg, args.policy, comp,
                                   closed_loop=closed, n_logical=n_logical,
                                   params=params, packed=packed,
                                   device=device)
                sync()

            pack_ok = can_pack(cfg, n_logical, params)
            row = {"t_len": t_len, "t_trim": comp.t_trim,
                   "fill": comp.fill, "n_pad": comp.n_pad}
            for label, fn in (("per_op", per_op),
                              ("compressed", compressed),
                              ("packed",
                               (lambda: compressed(True)) if pack_ok
                               else compressed)):
                with span(f"bench.{label}", "bench", trace=name,
                          t_len=t_len):
                    warm = _time_warm(fn, args.reps)
                row[label] = {"warm_s": round(warm, 6),
                              "ops_per_s": round(t_len / warm, 1)}
            row["speedup_compressed"] = round(
                row["compressed"]["ops_per_s"]
                / row["per_op"]["ops_per_s"], 3)
            row["speedup_packed"] = round(
                row["packed"]["ops_per_s"] / row["per_op"]["ops_per_s"], 3)
            traces[name] = row
            print(f"{name:>8}: T={t_len} trim={comp.t_trim} "
                  f"per_op {row['per_op']['ops_per_s'] / 1e6:.3f} -> "
                  f"compressed {row['compressed']['ops_per_s'] / 1e6:.3f} "
                  f"({row['speedup_compressed']:.2f}x) -> packed "
                  f"{row['packed']['ops_per_s'] / 1e6:.3f} Mops/s "
                  f"({row['speedup_packed']:.2f}x)")

    doc = {
        "policy": args.policy, "mode": args.mode,
        "max_ops": args.max_ops, "scale": args.scale, "reps": args.reps,
        "device": str(device), "git_sha": _git_sha(),
        "traces": traces,
        "spans": tracer.to_json(),
        "geomean_speedup": {
            "compressed": round(geomean(
                r["speedup_compressed"] for r in traces.values()), 3),
            "packed": round(geomean(
                r["speedup_packed"] for r in traces.values()), 3)},
    }
    gm = doc["geomean_speedup"]
    print(f"geomean speedup: compressed {gm['compressed']:.2f}x, "
          f"packed {gm['packed']:.2f}x")
    if args.chrome_trace:
        print(f"wrote {chrome_trace(tracer.to_json(), args.chrome_trace)}")
    if not args.no_save:
        path = save_bench("step_throughput", doc, directory=args.out_dir,
                          cfg=cfg, device=device)
        print(f"saved {path}")
        with open(path) as f:
            check_step_throughput(json.load(f),
                                  min_speedup=args.min_speedup)
    elif args.min_speedup:
        assert gm["compressed"] >= args.min_speedup, (
            f"compressed geomean speedup {gm['compressed']:.2f}x < "
            f"{args.min_speedup:.2f}x")
    if not args.no_history:
        from repro_torch.telemetry import history
        rec = history.append_record(
            "bench_step", f"{args.policy}/{args.mode}"
                          f":max_ops={args.max_ops}"
                          f":traces={','.join(names)}"
                          f":device={device.type}",
            directory=args.out_dir, git_sha=doc["git_sha"],
            ops_per_s=geomean(r["compressed"]["ops_per_s"]
                              for r in traces.values()),
            meta={"speedup_compressed": gm["compressed"],
                  "speedup_packed": gm["packed"]})
        print(f"history: appended {rec['kind']}:{rec['config']} "
              f"@ {str(rec['git_sha'])[:12]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
