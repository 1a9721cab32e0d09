"""Sweep CLI of the port: `python -m repro_torch.sweep.cli --grid paper`
runs the paper's evaluation grid (Figs. 9-12) through the fleet
simulator and writes `BENCH_torch_<name>.json` into `--out-dir`.

  python -m repro_torch.sweep.cli --grid paper              # on the card
  python -m repro_torch.sweep.cli --grid quick --device cpu --max-ops 2048
  python -m repro_torch.sweep.cli --grid stress             # scenarios
  python -m repro_torch.sweep.cli --grid mixed              # + bootstrap CIs
  python -m repro_torch.sweep.cli --grid endurance          # wear columns
  python -m repro_torch.sweep.cli --grid sensitivity        # one-axis deltas
  python -m repro_torch.sweep.cli --grid hostcache          # host-tier columns
  python -m repro_torch.sweep.cli --grid hostcache --device cpu --max-ops 512
  python -m repro_torch.sweep.cli --traces hm_0 --hostcache mode=wb,flush=idle
  python -m repro_torch.sweep.cli --traces hm_0,gc_pressure --seeds 0,1,2
  python -m repro_torch.sweep.cli --trace-file tests/data/sample_msr.csv \
      --policies baseline,ips --modes daily
  python -m repro_torch.sweep.cli --traces hm_0 --policies ips,ips_raro \
      --endurance w_rp=4,rp_budget=2
  python -m repro_torch.sweep.cli --grid paper --timeline   # + windows,
      # cliffs: BENCH_torch_timeline.json (1024 ops a window)
  python -m repro_torch.sweep.cli --grid quick --device cpu --max-ops 2048 \
      --timeline 64 --no-save
  python -m repro_torch.sweep.cli --list-policies | --list-grids
  python -m repro_torch.sweep.cli --search quick            # autotuning:
      # successive halving to a Pareto front (latency/WAF/TBW vs declared
      # baselines) and the scenario search: BENCH_torch_search.json
  python -m repro_torch.sweep.cli --search smoke --device cpu --max-ops 256
  python -m repro_torch.sweep.cli --grid paper --bench      # + the fleet
      # vs a loop of single cells over the 66-cell matrix: fleet_vs_loop

Port of the reference package's `sweep/cli.py`: the grids, the workload,
wear and host-cache flags (`--hostcache`, the host-tier table), the
telemetry probe (`--timeline`, the cliff table,
`--timeline-overhead-check`, `--chrome-trace`), `--profile`
(`torch.profiler`), the port's history file (`--history-check`,
`--no-history`), the search engine (`--search`, `--search-scenario`)
and `--bench` (the evaluation matrix's fleet against a loop of single
cells, `runner.bench_fleet_vs_loop`: on a card one launch for the fleet
against one launch a cell). Traces come through the port's own
compiled-trace cache (`$REPRO_TORCH_TRACE_CACHE_DIR`, by default
`~/.cache/repro_torch/traces`; `--no-trace-cache-disk` keeps it in
memory). Every artifact it writes
goes through `sweep.store` and is named `BENCH_torch_*.json` — the
history too, `BENCH_torch_history.json` — so it never overwrites a file
of the reference package. On the CPU the fleet runs the kernel's plain
version, an op at a time in Python: keep `--max-ops` small there.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
from dataclasses import replace

from repro_torch.sweep.grid import GRIDS

__all__ = ["main"]


def _parse(argv):
    ap = argparse.ArgumentParser(
        prog="repro_torch.sweep.cli",
        description="Batched sweeps over the hybrid-SSD fleet simulator "
                    "(paper Figs. 9-12), PyTorch / CUDA port.")
    ap.add_argument("--grid", choices=tuple(GRIDS), default=None,
                    help="named grid; omit to build one from "
                    "--traces/--policies/--modes")
    ap.add_argument("--traces", default=None,
                    help="comma list of workload specs: MSR names, "
                    "scenario names, or trace-file paths (default: all 11 "
                    "MSR traces)")
    ap.add_argument("--trace-file", action="append", default=[],
                    metavar="PATH", help="add a real trace file (MSR CSV, "
                    "generic CSV, fio iolog, blktrace; .gz ok) as a "
                    "workload; repeatable")
    ap.add_argument("--policies", default=None,
                    help="comma list of registered policy names (default: "
                    "baseline,ips,ips_agc); with --grid it replays the "
                    "grid's workload cells under these policies and their "
                    "declared baselines")
    ap.add_argument("--modes", default="bursty,daily")
    ap.add_argument("--endurance", nargs="?", const="", default=None,
                    metavar="K=V[,K=V...]",
                    help="track wear on every cell; optional knobs over "
                    "EnduranceSpec fields, e.g. w_rp=4,rp_budget=2,"
                    "read_penalty_ms=0.05 (bare flag: defaults). Overrides "
                    "a named grid's pinned knobs")
    ap.add_argument("--hostcache", nargs="?", const="", default=None,
                    metavar="K=V[,K=V...]",
                    help="put the host-tier block cache in front of every "
                    "cell; optional knobs over HostCacheSpec fields, e.g. "
                    "mode=wb,flush=watermark,sets=128,ways=8,wm_hi=0.75 "
                    "(bare flag: write-back defaults). Overrides a named "
                    "grid's pinned specs")
    ap.add_argument("--search", choices=("smoke", "quick", "full"),
                    default=None, metavar="BUDGET",
                    help="run the search engine instead of a sweep: "
                    "successive-halving policy autotuning to a Pareto "
                    "front and the adversarial scenario search at the "
                    "named budget (smoke|quick|full); writes "
                    "BENCH_torch_search.json")
    ap.add_argument("--search-scenario", default="ips:baseline",
                    metavar="A:B", help="policy pair for the scenario "
                    "search (default ips:baseline); 'none' skips it")
    ap.add_argument("--list-policies", action="store_true",
                    help="print the policy registry and exit")
    ap.add_argument("--list-grids", action="store_true",
                    help="print the named grids and exit")
    ap.add_argument("--seeds", default="0", help="comma list of RNG seeds; "
                    ">1 seed adds bootstrap CIs to the geomean summary")
    ap.add_argument("--cache-fracs", default="1.0",
                    help="comma list of SLC cache scale factors")
    ap.add_argument("--scale", type=int, default=None,
                    help="drive scale-down factor (default "
                    "driver.DEFAULT_SCALE, 128)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                    "kernel's plain version)")
    ap.add_argument("--max-ops", type=int, default=None,
                    help="truncate traces (smoke runs)")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks: N > 1 runs the sweep or the search on N "
                    "processes of one torch.distributed group, each its "
                    "slice of the cells, on the local cards (ranks share "
                    "a card when N exceeds their count; with --device "
                    "cpu, on the CPU); rank 0 prints and writes. Default "
                    "1: one process")
    ap.add_argument("--no-trace-cache-disk", action="store_true",
                    help="keep the compiled-trace cache in memory only")
    ap.add_argument("--timeline", nargs="?", const=1024, type=int,
                    default=None, metavar="WINDOW_OPS",
                    help="attach the telemetry probe: per-window latency/"
                    "occupancy/WAF series and cliff detection per cell, "
                    "written to BENCH_torch_<name>_timeline.json (default "
                    "window: 1024 ops)")
    ap.add_argument("--chrome-trace", default=None, metavar="PATH",
                    help="also write the run's span tree as a Chrome "
                    "trace-event file (chrome://tracing / Perfetto)")
    ap.add_argument("--timeline-overhead-check", action="store_true",
                    help="re-run the sweep warm with the probe off and on "
                    "(interleaved pairs, median of 3) and record the "
                    "wall-time ratio in the timeline artifact (requires "
                    "--timeline)")
    ap.add_argument("--history-check", action="store_true",
                    help="after appending this run to "
                    "BENCH_torch_history.json, fail (exit 1) on >20%% "
                    "throughput drop or any geomean drift vs the trailing "
                    "same-config baseline")
    ap.add_argument("--no-history", action="store_true",
                    help="skip the BENCH_torch_history.json append")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the sweep into "
                    "DIR (a Chrome trace; a no-op without a profiler "
                    "backend)")
    ap.add_argument("--bench", action="store_true",
                    help="also wall-clock the fleet against a loop of "
                    "eval_cell over the evaluation matrix (--max-ops "
                    "truncates both)")
    ap.add_argument("--name", default=None, help="artifact name: "
                    "BENCH_torch_<name>.json (default: sweep_<grid>)")
    ap.add_argument("--out-dir", default=".",
                    help="where BENCH_torch_<name>.json is written")
    ap.add_argument("--no-save", action="store_true")
    return ap.parse_args(argv)


def _select_points(args, seeds):
    """The sweep's points from --grid or --traces/--trace-file, with
    --policies/--modes/--cache-fracs/--endurance/--hostcache applied as
    the reference's CLI applies them; returns (points, error message)."""
    from repro_torch import workloads
    from repro_torch.core.ssd.endurance.spec import EnduranceSpec
    from repro_torch.hostcache.spec import HostCacheSpec
    from repro_torch.core.ssd.policies.registry import (baseline_of,
                                                        policy_names)
    from repro_torch.sweep.grid import SweepPoint, expand_grid, named_grid

    def unknown_policies(policies):
        bad = sorted(set(policies) - set(policy_names()))
        return (f"unknown --policies value(s) {','.join(bad)}; registered: "
                f"{','.join(policy_names())}") if bad else None

    if args.grid:
        if args.trace_file:
            return None, ("--trace-file cannot be combined with --grid "
                          "(named grids fix their workloads)")
        points = named_grid(args.grid)
        if args.policies:
            # replay the grid's workload cells under the requested
            # policies, each with its declared baseline
            req = tuple(dict.fromkeys(args.policies.split(",")))
            err = unknown_policies(req)
            if err:
                return None, err
            wanted = list(dict.fromkeys(
                sum(((p, baseline_of(p)) for p in req), ())))
            coords = list(dict.fromkeys(
                (pt.trace, pt.mode, pt.seed, pt.repeat, pt.cache_frac,
                 pt.idle_threshold_ms, pt.cap_boost_frac, pt.endurance,
                 pt.hostcache)
                for pt in points))
            points = [SweepPoint(trace=t, mode=m, policy=p, seed=s,
                                 repeat=r, cache_frac=c,
                                 idle_threshold_ms=i, cap_boost_frac=b,
                                 endurance=e, hostcache=h,
                                 baseline=baseline_of(p))
                      for (t, m, s, r, c, i, b, e, h) in coords
                      for p in wanted]
    else:
        traces = tuple(args.traces.split(",") if args.traces else
                       (workloads.TRACE_NAMES if not args.trace_file
                        else ()))
        traces += tuple(args.trace_file)
        policies = tuple((args.policies or "baseline,ips,ips_agc")
                         .split(","))
        modes = tuple(args.modes.split(","))
        bad, missing = [], []
        for t in sorted(set(traces)):
            try:
                kind = workloads.spec_kind(t)
            except ValueError:
                bad.append(t)
                continue
            if kind == "file" and not os.path.isfile(t):
                missing.append(t)
        if bad:
            return None, (f"unknown --traces value(s) {','.join(bad)}; "
                          f"valid: {','.join(workloads.known_specs())} "
                          "(or a trace-file path)")
        if missing:
            return None, f"trace file not found: {','.join(missing)}"
        err = unknown_policies(policies)
        if err:
            return None, err
        orphans = {p: baseline_of(p) for p in policies
                   if baseline_of(p) not in policies}
        if orphans:
            pol, base = sorted(orphans.items())[0]
            return None, (f"policy {pol!r} normalizes against {base!r}, "
                          "which is not in --policies; add it (baselines "
                          "are added automatically only with --grid)")
        unknown_modes = sorted(set(modes) - {"bursty", "daily"})
        if unknown_modes:
            return None, (f"unknown --modes value(s) "
                          f"{','.join(unknown_modes)}; valid: bursty,daily")
        if not traces:
            return None, "no workloads selected"
        points = [replace(pt, baseline=baseline_of(pt.policy))
                  for pt in expand_grid(
                      traces=traces, modes=modes, policies=policies,
                      seeds=seeds,
                      cache_fracs=tuple(float(c) for c in
                                        args.cache_fracs.split(",")))]
    if args.endurance is not None:
        try:
            endurance = EnduranceSpec.parse(args.endurance)
        except ValueError as e:
            return None, str(e)
        points = [replace(pt, endurance=endurance) for pt in points]
    if args.hostcache is not None:
        try:
            hostcache = HostCacheSpec.parse(args.hostcache)
        except ValueError as e:
            return None, f"--hostcache: {e}"
        points = [replace(pt, hostcache=hostcache) for pt in points]
    return points, None


def main(argv=None) -> int:
    args = _parse(argv if argv is not None else sys.argv[1:])
    import torch

    from repro_torch import workloads
    from repro_torch.configs.ssd_paper import PAPER_SSD
    from repro_torch.core.ssd.driver import DEFAULT_SCALE
    from repro_torch.core.ssd.policies.registry import get_entry, policy_names
    from repro_torch.sweep.report import (endurance_summary,
                                          hostcache_summary, policy_geomeans,
                                          policy_geomeans_ci,
                                          sensitivity_deltas,
                                          throughput_table)
    from repro_torch.sweep.runner import bench_fleet_vs_loop, run_sweep

    if args.list_policies:
        print(f"{'policy':<10}{'composition':<42}{'baseline':<10}doc")
        for name in policy_names():
            e = get_entry(name)
            doc = e.doc.partition(";")[0].partition(":")[0]
            print(f"{name:<10}{e.spec.composition:<42}{e.baseline:<10}"
                  f"{doc}")
        return 0
    if args.list_grids:
        print(f"{'grid':<13}{'cells':>6}  summary")
        for gname, fn in GRIDS.items():
            summary = (fn.__doc__ or "").strip().splitlines()[0]
            print(f"{gname:<13}{len(fn()):>6}  {summary}")
        return 0
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is available; "
              "pass --device cpu for the plain version", file=sys.stderr)
        return 2
    if args.devices < 1:
        print("error: --devices wants 1 or more ranks", file=sys.stderr)
        return 2
    if args.devices > 1 and args.bench:
        print("error: --bench times one process's fleet against its loop; "
              "drop --devices", file=sys.stderr)
        return 2
    from repro_torch.distributed import group as dgroup
    if args.devices > 1 and dgroup.world_size() == 1:
        argv = list(argv if argv is not None else sys.argv[1:])
        return dgroup.spawn(_rank_main, args.devices, argv,
                            device=args.device)[0]
    if dgroup.rank() != 0:
        # rank 0 alone writes the artifacts
        args.no_save, args.chrome_trace, args.profile = True, None, None
        args.history_check = False
    seeds = tuple(int(s) for s in args.seeds.split(","))
    if args.search:
        conflicts = [flag for flag, used in (
            ("--grid", args.grid), ("--traces", args.traces),
            ("--trace-file", args.trace_file),
            ("--policies", args.policies),
            ("--endurance", args.endurance is not None),
            ("--hostcache", args.hostcache is not None),
            ("--modes", args.modes != "bursty,daily"),
            ("--cache-fracs", args.cache_fracs != "1.0"),
            ("--timeline", args.timeline is not None),
            ("--timeline-overhead-check", args.timeline_overhead_check),
            ("--bench", args.bench),
            ("--seeds (search scores one seed)", len(seeds) > 1),
        ) if used]
        if conflicts:
            print("error: --search runs its own candidate space and round "
                  "schedule (repro_torch.search.SPACES/SCHEDULES); drop "
                  + ", ".join(conflicts), file=sys.stderr)
            return 2
        return _run_search(args, seeds[0])
    if args.search_scenario != "ips:baseline":
        print("error: --search-scenario only applies to --search runs",
              file=sys.stderr)
        return 2
    points, err = _select_points(args, seeds)
    if err:
        print(f"error: {err}", file=sys.stderr)
        return 2
    if args.timeline_overhead_check and not args.timeline:
        print("error: --timeline-overhead-check requires --timeline",
              file=sys.stderr)
        return 2
    if args.timeline is not None and args.timeline <= 0:
        print("error: --timeline wants a positive window size (ops)",
              file=sys.stderr)
        return 2

    from repro_torch.kernels.ssd_step import ops as ssd_step
    from repro_torch.sweep.store import save_bench
    from repro_torch.telemetry import (Tracer, chrome_trace, history,
                                       profiling, timeline_payload)
    from repro_torch.telemetry import timeline as tmod
    from repro_torch.telemetry.spans import span

    scale = args.scale or DEFAULT_SCALE
    cfg = PAPER_SSD.scaled(scale)
    cache = workloads.TraceCache(use_disk=not args.no_trace_cache_disk)
    tracer = Tracer() if (args.timeline or args.chrome_trace) else None
    timelines = {} if args.timeline else None
    print(f"sweep: {len(points)} cells on a 1/{scale} drive "
          f"({cfg.capacity_gb:.1f} GB) on {args.device}")
    timings = []
    launches0 = ssd_step.launches
    overhead = None

    def sweep(**kw):
        return run_sweep(cfg, points, max_ops=args.max_ops,
                         device=args.device, trace_cache=cache, **kw)

    with (tracer.activate() if tracer else contextlib.nullcontext()):
        with profiling.profile(args.profile):
            with span("sweep.run", "sweep", cells=len(points)) as rec:
                results = sweep(timings=timings,
                                progress=lambda s: print(f"  {s}"),
                                timeline_ops=args.timeline,
                                timelines=timelines)
                if torch.device(args.device).type == "cuda":
                    torch.cuda.synchronize()
            profiling.emit_device_events("sweep.done")
        wall = rec["dur_s"]
        launches = ssd_step.launches - launches0
        if args.timeline_overhead_check:
            overhead = _overhead(sweep, args.timeline, args.device)
            print(f"  timeline overhead: off {overhead['off_warm_s']:.3f}s "
                  f"-> on {overhead['on_warm_s']:.3f}s warm, median of "
                  f"{overhead['pairs']} (ratio {overhead['ratio']:.3f})")
    cstats = cache.stats()
    print(f"  trace cache: {cstats['hits']} hit(s), {cstats['misses']} "
          "miss(es)")
    padded = sum(g["cells"] * g["t_len"] for g in timings)
    throughput = {"wall_s": wall, "ops_per_s": padded / max(wall, 1e-9),
                  "cells_per_s": len(points) / max(wall, 1e-9)}
    print(f"  {len(timings)} group(s) in {wall:.3f} s, {launches} kernel "
          f"launch(es): {throughput['ops_per_s'] / 1e6:.3f} Mops/s over "
          "the padded length")
    print(throughput_table(timings))
    _print_table(results)
    geomeans = {f"{m}/{p}": v for (m, p), v in
                sorted(policy_geomeans(results).items())}
    payload = {"geomeans": geomeans}
    if any("tbw_proj_gb" in v for v in results.values()):
        endur = endurance_summary(results)
        _print_endurance_table(endur)
        payload["endurance"] = {f"{m}/{p}": v for (m, p), v in
                                sorted(endur.items())}
    if any("host_hit_rate" in v for v in results.values()):
        hc = hostcache_summary(results)
        _print_hostcache_table(hc)
        payload["hostcache"] = {f"{m}/{p}/{t}": v for (m, p, t), v in
                                sorted(hc.items())}
    if args.grid == "sensitivity":
        deltas = sensitivity_deltas(results)
        _print_sensitivity_table(deltas)
        payload["sensitivity"] = {"/".join(k): v
                                  for k, v in sorted(deltas.items())}
    if len({pt.seed for pt in points}) > 1:
        cis = policy_geomeans_ci(results)
        _print_ci_table(cis)
        payload["geomeans_ci"] = {f"{m}/{p}": v
                                  for (m, p), v in sorted(cis.items())}
    if args.bench:
        print("\nbenchmark: fleet vs looped eval_cell (full matrix) ...")
        bench = bench_fleet_vs_loop(cfg, max_ops=args.max_ops,
                                    device=args.device)
        print(f"  loop {bench['loop_wall_s']:.1f}s -> fleet "
              f"{bench['fleet_wall_s']:.1f}s  "
              f"(speedup {bench['speedup']:.2f}x, max rel diff "
              f"{bench['max_rel_diff']:.2e})")
        payload["fleet_vs_loop"] = {k: v for k, v in bench.items()
                                    if k != "results"}
    meta = {"grid": args.grid or "custom", "n_cells": len(points),
            "max_ops": args.max_ops, "scale": scale,
            "device": args.device, "launches": launches}
    if args.timeline:
        cells = {pt.key: tmod.series(tl)
                 for pt, tl in sorted(timelines.items(),
                                      key=lambda kv: kv[0].key)}
        _print_cliff_table(cells)
        tl_doc = timeline_payload(
            cells, window_ops=args.timeline, tracer=tracer,
            extra={**meta, **({"overhead": overhead} if overhead else {})})
        if not args.no_save:
            tl_name = (f"{args.name}_timeline" if args.name
                       else "timeline")
            tl_path = save_bench(tl_name, tl_doc, cfg=cfg,
                                 directory=args.out_dir, device=args.device)
            print(f"wrote {tl_path}")
    if args.chrome_trace:
        print(f"wrote {chrome_trace(tracer.to_json(), args.chrome_trace)}")
    if not args.no_save:
        name = args.name or f"sweep_{args.grid or 'custom'}"
        doc = {**meta, "trace_cache": cstats, "group_timings": timings,
               "throughput": throughput,
               "results": {pt.key: v for pt, v in sorted(
                   results.items(), key=lambda kv: kv[0].key)},
               **payload}
        path = save_bench(name, doc, cfg=cfg, directory=args.out_dir,
                          device=args.device)
        print(f"\nwrote {path}")
        if not args.no_history:
            # fidelity geomeans flattened to scalars: the history gate
            # treats any drift as a regression
            flat_gm = {f"{k}/{metric}": v[metric]
                       for k, v in geomeans.items()
                       for metric in ("mean_write_latency_ms", "wa_paper")
                       if metric in v}
            # the host-tier ratios are deterministic too
            flat_gm |= {f"hc:{k}/{metric}": v[metric]
                        for k, v in payload.get("hostcache", {}).items()
                        for metric in ("lat_vs_off", "wa_vs_off")
                        if v.get(metric) is not None}
            rec = history.append_record(
                "sweep", f"{args.grid or 'custom'}:scale={scale}"
                         f":max_ops={args.max_ops}:seeds={len(seeds)}"
                         f":device={torch.device(args.device).type}",
                directory=args.out_dir,
                ops_per_s=throughput["ops_per_s"],
                cells_per_s=throughput["cells_per_s"], geomeans=flat_gm,
                meta={"n_cells": len(points), "timeline": args.timeline,
                      "launches": launches})
            print(f"history: appended {rec['kind']}:{rec['config']} "
                  f"@ {str(rec['git_sha'])[:12]}")
    if args.history_check:
        failures = history.check_regression(
            history.load_history(args.out_dir)["records"])
        if failures:
            for line in failures:
                print(f"REGRESSION {line}", file=sys.stderr)
            return 1
        print("history: no regression vs trailing baseline")
    return 0


def _overhead(sweep, window_ops: int, device) -> dict:
    """The probe's cost: the sweep warm with the probe off and on, in
    interleaved off/on pairs (the host's load drifts on the scale of one
    pass, and sequential one-shot timings alias that drift into the
    ratio), median of 3. On the card each pass's kernel launch is timed
    by its CUDA events too."""
    import torch

    from repro_torch.telemetry.spans import span
    cuda = torch.device(device).type == "cuda"

    def timed(**kw):
        timings = []
        with span("overhead.pass", "bench", **kw) as rec:
            sweep(timings=timings, **kw)
            if cuda:
                torch.cuda.synchronize()
        return rec["dur_s"], timings[0]["launch_ms"] if timings else None

    timed()                             # warm: traces built, kernel loaded
    offs, ons = [], []
    for _ in range(3):
        offs.append(timed())
        ons.append(timed(timeline_ops=window_ops))

    def med(xs, i):
        return sorted(x[i] for x in xs)[1]

    off_s, on_s = med(offs, 0), med(ons, 0)
    out = {"off_warm_s": off_s, "on_warm_s": on_s, "pairs": 3,
           "ratio": on_s / max(off_s, 1e-9)}
    if cuda:
        off_ms, on_ms = med(offs, 1), med(ons, 1)
        out.update({"off_launch_ms": off_ms, "on_launch_ms": on_ms,
                    "launch_ratio": on_ms / max(off_ms, 1e-9)})
    return out


def _print_cliff_table(cells) -> None:
    print("\n=== timeline: performance-cliff detection ===")
    rows = [(k, s["cliff"]) for k, s in cells.items()
            if s["cliff"]["detected"]]
    if rows:
        print(f"{'cell':<40}{'window':>7}{'ratio':>8}{'steady':>9}"
              f"{'t_ops':>9}{'recov':>8}")
        for key, c in rows:
            recov = ("" if c["recovery_slope"] is None
                     else f"{c['recovery_slope']:>8.3f}")
            print(f"{key:<40}{c['window']:>7}{c['ratio']:>8.2f}"
                  f"{c['steady_lat_ms']:>9.3f}"
                  f"{c['time_to_cliff_ops']:>9}{recov}")
    print(f"  cliffs: {len(rows)}/{len(cells)} cell(s)")


def _print_table(results) -> None:
    from repro_torch.sweep.report import normalize_points, policy_geomeans
    lat = normalize_points(results, "mean_write_latency_ms")
    wa = normalize_points(results, "wa_paper")
    if lat:
        print(f"\n{'cell':<40}{'lat/base':>10}{'wa/base':>10}")
        for point in sorted(lat, key=lambda p: p.key):
            print(f"{point.key:<40}{lat[point]:>10.3f}"
                  f"{wa.get(point, float('nan')):>10.3f}")
    print("\n=== geomeans vs declared baseline ===")
    for (mode, policy), v in sorted(policy_geomeans(results).items()):
        print(f"{mode:>7} {policy:<8} "
              f"lat={v.get('mean_write_latency_ms', float('nan')):.4f} "
              f"wa={v.get('wa_paper', float('nan')):.4f}  (n={v['n']})")


def _print_endurance_table(endur) -> None:
    print("\n=== endurance: lifetime + wear leveling ===")
    print(f"{'mode':>7} {'policy':<9}{'tbw/base':>9}{'eol/base':>9}"
          f"{'cyc_max':>9}{'skew':>7}{'eol%':>6}")
    for (mode, policy), v in sorted(endur.items()):
        def fmt(x):
            # "ref": a reference cell; "n/a": no comparable pairs
            if x is not None:
                return f"{x:.3f}"
            return "ref" if v["is_ref"] else "n/a"
        print(f"{mode:>7} {policy:<9}{fmt(v['tbw_ratio']):>9}"
              f"{fmt(v['eol_ratio']):>9}{v['eff_cycles_max']:>9.1f}"
              f"{v['cycle_skew']:>7.3f}{v['eol_frac']:>6.0%}")


def _print_hostcache_table(hc) -> None:
    print("\n=== host-tier cache: hit rate + device-visible writes ===")
    print(f"{'mode':>7} {'policy':<9}{'hostcache':<22}{'hit':>7}"
          f"{'devw':>7}{'lat/off':>9}{'wa/off':>8}")
    for (mode, policy, tag), v in sorted(hc.items()):
        def fmt(x):
            return f"{x:.3f}" if x is not None else "n/a"
        print(f"{mode:>7} {policy:<9}{tag:<22}"
              f"{v['host_hit_rate']:>7.3f}{v['host_dev_write_frac']:>7.3f}"
              f"{fmt(v['lat_vs_off']):>9}{fmt(v['wa_vs_off']):>8}")


def _run_search(args, seed: int) -> int:
    """`--search BUDGET`: policy autotuning and the scenario search ->
    BENCH_torch_search.json."""
    import torch

    from repro_torch import workloads
    from repro_torch.configs.ssd_paper import PAPER_SSD
    from repro_torch.core.ssd.driver import DEFAULT_SCALE
    from repro_torch.core.ssd.policies.registry import policy_names
    from repro_torch.search import (SCHEDULES, build_space,
                                    group_candidates, separation_search,
                                    successive_halving)
    from repro_torch.search.tune import \
        specialisations as tune_specialisations
    from repro_torch.sweep.report import (search_front_table,
                                          search_rounds_table)
    from repro_torch.sweep.store import save_bench
    from repro_torch.telemetry import Tracer, chrome_trace, history
    from repro_torch.telemetry.spans import span

    budget = args.search
    sched = SCHEDULES[budget]
    scen_pair = None
    if args.search_scenario.lower() != "none":
        scen_pair = tuple(args.search_scenario.split(":"))
        unknown = sorted(set(scen_pair) - set(policy_names()))
        if len(scen_pair) != 2 or unknown:
            print(f"error: --search-scenario wants A:B over registered "
                  f"policies, got {args.search_scenario!r}"
                  + (f" (unknown: {','.join(unknown)})" if unknown else ""),
                  file=sys.stderr)
            return 2
    rounds = [dict(r) for r in sched["rounds"]]
    if args.max_ops:                 # smoke tightening: cap every round
        for r in rounds:
            r["max_ops"] = (args.max_ops if r["max_ops"] is None
                            else min(r["max_ops"], args.max_ops))
    scale = args.scale or DEFAULT_SCALE
    cfg = PAPER_SSD.scaled(scale)
    space = build_space(budget)
    print(f"search[{budget}]: {len(space)} candidate(s) in "
          f"{len(group_candidates(space))} composition group(s), "
          f"{len(rounds)} round(s) on a 1/{scale} drive on {args.device}")
    cache = workloads.TraceCache(use_disk=not args.no_trace_cache_disk)
    tracer = Tracer() if args.chrome_trace else None
    spec0 = tune_specialisations()
    with (tracer.activate() if tracer else contextlib.nullcontext()):
        tune = successive_halving(
            cfg, space, rounds, seed=seed, keep_frac=sched["keep_frac"],
            min_keep=sched["min_keep"], trace_cache=cache,
            progress=lambda s: print(f"  {s}"), device=args.device)
    doc = tune.to_json()
    if args.chrome_trace:
        print(f"wrote {chrome_trace(tracer.to_json(), args.chrome_trace)}")
    print("\n=== search rounds (survivors / new kernel specialisations per "
          "round) ===")
    print(search_rounds_table(tune.rounds))
    print("\n=== Pareto front: lat/waf/tbw vs declared baselines ===")
    print(search_front_table(doc["front"]))

    scen = None
    if scen_pair is not None:
        sc = sched["scenario"]
        max_ops = (min(sc["max_ops"], args.max_ops) if args.max_ops
                   else sc["max_ops"])
        print(f"\nscenario search: separate {scen_pair[0]} vs "
              f"{scen_pair[1]} ({sc['iters']} iter(s) x {sc['pop']})")
        with span("search.scenario", "search") as rec:
            scen = separation_search(
                cfg, scen_pair[0], scen_pair[1], seed=seed,
                iters=sc["iters"], pop=sc["pop"], max_ops=max_ops,
                progress=lambda s: print(f"  {s}"), device=args.device)
            if torch.device(args.device).type == "cuda":
                torch.cuda.synchronize()
        scen["wall_s"] = rec["dur_s"]
        print(f"  msr geomean {scen['msr_geomean']:.3f} -> found "
              f"{scen['best_ratio']:.3f}: ranking "
              f"{'FLIPS' if scen['flipped'] else 'does not flip'}")

    specialisations = tune_specialisations() - spec0
    payload = {"search": budget, "n_candidates": len(space),
               "space": [c.to_json() for c in space],
               "trace_cache": cache.stats(), "device": args.device,
               "specialisations": specialisations, **doc}
    if scen is not None:
        payload["scenario_search"] = scen
    if not args.no_save:
        path = save_bench(args.name or "search", payload, cfg=cfg,
                          directory=args.out_dir, device=args.device)
        print(f"\nwrote {path}")
        if not args.no_history:
            total_cells = sum(r.get("cells", 0) for r in doc["rounds"])
            wall = sum(r.get("wall_s", 0.0) for r in doc["rounds"])
            rec = history.append_record(
                "search", f"{budget}:scale={scale}:max_ops={args.max_ops}"
                          f":device={torch.device(args.device).type}",
                directory=args.out_dir,
                cells_per_s=(total_cells / wall if wall else None),
                compiles=specialisations,
                meta={"n_candidates": len(space),
                      "front_size": len(doc["front"])})
            print(f"history: appended {rec['kind']}:{rec['config']} "
                  f"@ {str(rec['git_sha'])[:12]}")
    return 0


def _rank_main(rank: int, world: int, argv) -> int:
    """One rank of `--devices N`: `main` inside the started group, its
    output kept on rank 0's stdout alone."""
    if rank == 0:
        return main(argv)
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        return main(argv)


def _print_sensitivity_table(deltas) -> None:
    print("\n=== sensitivity: one-axis swaps around ips (ratios vs ips) ===")
    print(f"{'axis':<11}{'swap':<29}{'policy':<9}{'mode':<7}"
          f"{'lat':>7}{'wa':>7}")
    for (axis, swap, policy, mode), v in sorted(deltas.items()):
        print(f"{axis:<11}{swap:<29}{policy:<9}{mode:<7}"
              f"{v.get('mean_write_latency_ms', float('nan')):>7.3f}"
              f"{v.get('wa_paper', float('nan')):>7.3f}")


def _print_ci_table(cis) -> None:
    print("\n=== seed-pooled geomeans, 95% bootstrap CI ===")
    for (mode, policy), v in sorted(cis.items()):
        def fmt(d):
            return (f"{d['geomean']:.3f} [{d['lo']:.3f},{d['hi']:.3f}]"
                    if d else "n/a")
        print(f"{mode:>7} {policy:<8} "
              f"lat={fmt(v.get('mean_write_latency_ms'))} "
              f"wa={fmt(v.get('wa_paper'))}  "
              f"(n={v['n']}, seeds={v['n_seeds']})")


if __name__ == "__main__":
    sys.exit(main())
