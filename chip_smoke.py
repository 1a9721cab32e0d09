#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit (`nvcc`). It builds every kernel of the port's main path
from the sources in the checkout, then:

1. device — prints the card's name and power limit as
   `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
   them, and the build time;
2. kernel vs plain version — the `ssd_step` kernel on the card against
   its plain PyTorch version on the CPU, on the same inputs: the paper's
   4 policies x 2 modes on `hm_0` and `proj_0` (4096 ops plus an
   8192-op pad tail, at the paper's full width: 128 planes, 2^16 logical
   pages), in the per-op form (K = 1) and the compressed form (K = 32).
   Every carry leaf and every latency must be equal (tolerance 0: the
   port is bit-exact);
3. main path — the full 102-cell `paper` grid through
   `repro_torch.sweep.runner.run_sweep` on the card, untruncated, held
   against the committed `BENCH_sweep_paper.json` of the reference
   package: counters, `wa_paper` and `wa_raw` exact, mean write latency
   within rtol 1e-6 (the reference sums float32 latencies in its own
   order). The kernel's launch count is zeroed just before and read
   just after: it must equal the number of (composition, mode, length)
   groups.

Each phase prints one JSON line and any mismatch fails the run. The line
before the last is the kernel table (`{"kernels": [...]}`); the last is
`{"ok": true, "device": {...}}`. Without a CUDA device, or outside a
checkout, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
# float32 operations one op of the per-op core does on the heaviest
# composition (coop, daily), counted in csrc/ssd_step.cu and rounded up;
# the pad ops replayed in the kernel are not counted
CORE_F32_OPS = 32
SMOKE_OPS = 4096                # live ops per phase-2 trace
SMOKE_PAD = 8192                # identical tail pads per phase-2 trace
EXACT = ("wa_paper", "wa_raw", "slc_writes", "tlc_writes", "reprogram_host",
         "reprogram_agc", "reprogram_trad", "migrations", "erases",
         "host_pages", "conflict_ms", "n_ops")


def emit(obj) -> None:
    print(json.dumps(obj, sort_keys=True), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def stream_bytes(c_cnt: int, n_ops: int, plan: bool, n_planes: int,
                 n_logical: int) -> int:
    """Bytes the kernel must move for C cells of `n_ops` scanned ops:
    each input read once, each output written once."""
    per_op = 4 + 4 + 4 + (8 if plan else 0) + 4    # ops (+ plan) + latency
    carry = 7 * 4 * n_planes + 3 * n_logical + 4 * 12
    params = 6 * 4
    return c_cnt * (n_ops * per_op + 2 * carry + params)


def bound_ms(bytes_moved: int, ops: int):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def leaves_equal(label, got, want) -> float:
    """Exact equality of (latency, SimState) pairs; returns the largest
    absolute difference over the float leaves (0.0 when equal)."""
    import torch
    lat_g, st_g = got
    lat_w, st_w = want
    pairs = [("latency", lat_g, lat_w)] + [
        (f, getattr(st_g, f), getattr(st_w, f)) for f in st_g._fields]
    err = 0.0
    for name, g, w in pairs:
        g = g.cpu()
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"{label}: {name} is {g.dtype}{tuple(g.shape)}, plain "
                 f"version {w.dtype}{tuple(w.shape)}")
        if g.is_floating_point():
            err = max(err, float((g - w).abs().max()) if g.numel() else 0.0)
        if not torch.equal(g, w):
            fail(f"{label}: {name} differs from the plain version")
    return err


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the card")
    bench_path = os.path.join(ROOT, "BENCH_sweep_paper.json")
    if not os.path.exists(bench_path):
        fail(f"{bench_path} is missing: run from the root of a checkout")

    from repro_torch.configs.ssd_paper import PAPER_SSD
    from repro_torch.core.ssd.policies.registry import PAPER_POLICIES
    from repro_torch.core.ssd.policies.state import CellParams, init_state
    from repro_torch.core.ssd.sim import default_params
    from repro_torch.kernels.ssd_step import ops as ssd_step
    from repro_torch.sweep.grid import paper_grid
    from repro_torch.sweep.report import policy_geomeans
    from repro_torch.sweep.runner import run_sweep
    from repro_torch.workloads import build_ops, compress_ops, truncate_trace

    # ---- 1. device and build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    t0 = time.perf_counter()
    lib = ssd_step.build()
    build_s = time.perf_counter() - t0
    log = ssd_step.build_log.splitlines()
    regs = sorted({int(ln.split("Used ")[1].split()[0])
                   for ln in log if "registers" in ln})
    spills = max((int(ln.split("bytes spill stores")[0].split(",")[-1])
                  for ln in log if "bytes spill stores" in ln), default=0)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "library": os.path.relpath(lib, ROOT),
          "ptxas_registers": regs, "ptxas_max_spill_store_bytes": spills})

    cfg = PAPER_SSD.scaled(128)
    n_logical = min(cfg.total_pages, 1 << 16)
    cuda = torch.device("cuda", 0)
    torch.set_num_threads(1)       # the plain version runs 0-d tensor ops

    # ---- 2. kernel vs plain version, same inputs ----
    def padded(name):
        ops = truncate_trace(build_ops(name, n_logical,
                                       capacity_pages=cfg.total_pages),
                             SMOKE_OPS)
        return {"arrival_ms": np.concatenate(
                    [ops["arrival_ms"], np.full(SMOKE_PAD,
                                                ops["arrival_ms"][-1],
                                                np.float32)]),
                "lba": np.concatenate([ops["lba"],
                                       np.zeros(SMOKE_PAD, np.int32)]),
                "is_write": np.concatenate(
                    [ops["is_write"], np.full(SMOKE_PAD, -1, np.int8)])}

    traces = [padded(n) for n in ("hm_0", "proj_0")]
    plans = [compress_ops(t, quantum=1024) for t in traces]
    c_cnt = len(traces)
    per_op = {k: np.stack([t[k][:SMOKE_OPS] for t in traces])
              .astype(np.float32 if k == "arrival_ms" else np.int32)
              .reshape(c_cnt, SMOKE_OPS, 1) for k in traces[0]}
    seg = {k: np.stack([p.segs[k] for p in plans]) for k in plans[0].segs}
    pad_t = np.float32([t["arrival_ms"][SMOKE_OPS] for t in traces])
    assert all(p.n_pad == SMOKE_PAD and p.pad_t == pt
               for p, pt in zip(plans, pad_t))

    ssd_step.reset()
    cases, kernel_ms, plain_s, max_err = [], 0.0, 0.0, 0.0
    for policy in PAPER_POLICIES:
        for mode in ("daily", "bursty"):
            params = CellParams(*(torch.stack([x, x]) for x in
                                  default_params(cfg, policy, 0.05,
                                                 device="cpu")))
            for form, arrays in (("K=1", per_op), ("K=32", seg)):
                res = {}
                for dev in (cuda, torch.device("cpu")):
                    segs = {k: torch.from_numpy(v).to(dev)
                            for k, v in arrays.items()}
                    state0 = init_state(cfg, n_logical, packed=True,
                                        n_cells=c_cnt, device=dev)
                    t1 = time.perf_counter()
                    res[dev.type] = ssd_step.run_stream(
                        cfg, policy, segs, state0,
                        closed_loop=(mode == "bursty"),
                        params=CellParams(*(x.to(dev) for x in params)),
                        n_pad=SMOKE_PAD,
                        pad_t=torch.from_numpy(pad_t).to(dev))
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                        start, end = ssd_step.events[-1]
                        if form == "K=1":
                            kernel_ms += start.elapsed_time(end)
                    elif form == "K=1":
                        plain_s += time.perf_counter() - t1
                label = f"{policy}/{mode}/{form}"
                max_err = max(max_err, leaves_equal(label, res["cuda"],
                                                    res["cpu"]))
                cases.append(label)
    smoke_launches = ssd_step.launches
    if smoke_launches != len(cases):
        fail(f"phase 2 launched the kernel {smoke_launches} times for "
             f"{len(cases)} comparisons")
    smoke_bytes = 8 * stream_bytes(c_cnt, SMOKE_OPS, False, cfg.num_planes,
                                   n_logical)
    smoke_bound, smoke_by = bound_ms(
        smoke_bytes, 8 * c_cnt * SMOKE_OPS * CORE_F32_OPS)
    emit({"phase": "kernel_vs_plain", "cases": len(cases),
          "cells_per_case": c_cnt, "ops": SMOKE_OPS, "pad": SMOKE_PAD,
          "forms": ["K=1", "K=32"], "equal": True, "max_abs_err": max_err,
          "launches": smoke_launches, "kernel_ms_k1": kernel_ms,
          "plain_ms_k1": plain_s * 1e3, "bound_ms_k1": smoke_bound})

    # ---- 3. the main path: the paper grid on the card ----
    with open(bench_path) as f:
        bench = json.load(f)
    points = paper_grid()
    timings = []
    ssd_step.reset()
    t1 = time.perf_counter()
    results = run_sweep(cfg, points, device=cuda, timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = ssd_step.launches
    if launches == 0 or launches != len(timings):
        fail(f"main path launched the kernel {launches} times for "
             f"{len(timings)} groups")
    worst = 0.0
    for pt in points:
        got, want = results[pt], bench["results"].get(pt.key)
        if want is None:
            fail(f"{pt.key} is not in {bench_path}")
        for key in EXACT:
            if got[key] != want[key]:
                fail(f"{pt.key}: {key} = {got[key]!r}, reference "
                     f"{want[key]!r}")
        a, b = got["mean_write_latency_ms"], want["mean_write_latency_ms"]
        if not np.isfinite(a) or abs(a - b) > 1e-6 * abs(b):
            fail(f"{pt.key}: mean_write_latency_ms = {a!r}, reference "
                 f"{b!r}")
        worst = max(worst, abs(a - b) / max(abs(b), 1e-30))
    geomeans = {f"{m}/{p}": v for (m, p), v in
                sorted(policy_geomeans(results).items())}
    for key, v in geomeans.items():
        for metric in ("mean_write_latency_ms", "wa_paper"):
            ref = bench["geomeans"][key][metric]
            if abs(v[metric] - ref) > 1e-6 * abs(ref):
                fail(f"geomean {key}/{metric} = {v[metric]!r}, reference "
                     f"{ref!r}")
    grid_ms = sum(g["kernel_ms"] for g in timings)
    padded_ops = sum(g["cells"] * g["t_len"] for g in timings)
    grid_bytes = sum(stream_bytes(g["cells"], g["t_scan"], False,
                                  cfg.num_planes, n_logical)
                     for g in timings)
    grid_bound, grid_by = bound_ms(
        grid_bytes, sum(g["cells"] * g["t_scan"] for g in timings)
        * CORE_F32_OPS)
    emit({"phase": "main_path", "cells": len(points),
          "groups": len(timings), "launches": launches,
          "matches_reference": True, "mean_latency_max_rel_err": worst,
          "wall_s": wall, "ops_per_s": padded_ops / wall,
          "kernel_ms": grid_ms, "bound_ms": grid_bound,
          "geomeans": {k: {m: v[m] for m in ("mean_write_latency_ms",
                                             "wa_paper")}
                       for k, v in geomeans.items()},
          "group_kernel_ms": [{"group": f"{g['composition']}/{g['mode']}",
                               "cells": g["cells"], "t_len": g["t_len"],
                               "t_scan": g["t_scan"],
                               "kernel_ms": g["kernel_ms"]}
                              for g in timings]})

    # ---- the kernel table, then the contract's last line ----
    emit({"kernels": [{
        "name": "ssd_step", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_step/csrc/ssd_step.cu",
        "replaces": "src/repro/kernels/ssd_step/kernel.py:46",
        "launches": launches,
        # ms / plain_ms / bound_ms: the same work — phase 2's eight K = 1
        # launches, which the CPU plain version can also run
        "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_s * 1e3,
        "bound_ms": smoke_bound, "bound_by": smoke_by, "library_ms": None,
        # the main path: all of the paper grid's launches
        "main_path_ms": grid_ms, "main_path_bound_ms": grid_bound,
        "main_path_bound_by": grid_by}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
