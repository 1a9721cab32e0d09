"""Workload-engine zoo on the PyTorch / CUDA port (the counterpart of
`examples/workload_zoo.py`): every way to get a trace, through one
interface.

Builds the 11 synthetic MSR traces, each parametric scenario generator,
a real trace file (the test fixture), and a multi-tenant mix; fits
`TraceStats` back from each and prints the zoo as a table — the round
trip that validates the synthetic path against real inputs (DESIGN.md
§7). The zoo is host numpy, identical to the reference's.

Run: PYTHONPATH=src python examples/workload_zoo_torch.py [--simulate] \\
         [--device cpu]

--simulate additionally runs a tiny fleet sweep over one workload of each
kind (MSR name, scenario, file) to show they share the simulator path:
one `ssd_step` launch on the card.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch import workloads as wl  # noqa: E402
from repro_torch.configs.ssd_paper import PAPER_SSD  # noqa: E402
from repro_torch.sweep.grid import SweepPoint  # noqa: E402
from repro_torch.sweep.runner import run_sweep  # noqa: E402

N_LOGICAL = 1 << 16
CAPACITY = 786432                       # scale-128 drive, in pages
FIXTURE = os.path.join(os.path.dirname(__file__), "..", "tests", "data",
                       "sample_msr.csv")


def show(label: str, trace: wl.Trace) -> None:
    st = wl.fit_stats(trace, N_LOGICAL, CAPACITY)
    print(f"{label:<26} {trace.n_ops:>8} ops {trace.n_reqs:>7} reqs  "
          f"wr={st.write_ratio:.2f} seq={st.seq_prob:.2f} "
          f"ws={st.working_set_frac:.4f} skew={st.skew:.1f} "
          f"ia={st.interarrival_ms:.2f}ms "
          f"idle={st.idle_ms:.0f}ms/{st.idle_every}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--simulate", action="store_true",
                    help="also run a 3-workload fleet sweep")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel) or cpu (its plain version), "
                         "for --simulate")
    args = ap.parse_args(argv)
    if args.simulate and torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (use --device cpu "
                         "for the kernel's plain version)")

    print("== synthetic MSR set (published stats) ==")
    for name in wl.TRACE_NAMES:
        show(name, wl.build_trace(name, N_LOGICAL,
                                  capacity_pages=CAPACITY))

    print("\n== parametric scenario generators ==")
    for name in wl.SCENARIO_NAMES:
        show(name, wl.build_trace(name, N_LOGICAL,
                                  capacity_pages=CAPACITY))

    print("\n== real trace file (parsers.load_trace) ==")
    tr = wl.load_trace(FIXTURE, total_logical_pages=N_LOGICAL)
    show(os.path.basename(FIXTURE), tr)
    twin = wl.synthesize_like(tr, N_LOGICAL, CAPACITY)
    show("  synthetic twin", twin)

    print("\n== IR transforms compose ==")
    hot = wl.build_trace("zipf_hot", N_LOGICAL, capacity_pages=CAPACITY)
    show("zipf_hot @2x rate", hot.scale_rate(2.0))
    show("zipf_hot 30% writes", hot.shift_write_ratio(0.3))
    show("mix(hot, fixture)", wl.mix_traces([hot, tr], N_LOGICAL))

    if args.simulate:
        print("\n== one fleet sweep, three workload kinds ==")
        cfg = PAPER_SSD.scaled(128)
        points = [SweepPoint(t, "daily", p)
                  for t in ("hm_0", "gc_pressure", FIXTURE)
                  for p in ("baseline", "ips_agc")]
        res = run_sweep(cfg, points, max_ops=8192, device=args.device,
                        progress=lambda s: print(f"  {s}"))
        for pt in points:
            r = res[pt]
            print(f"  {pt.key:<44} lat={r['mean_write_latency_ms']:.3f}ms "
                  f"wa={r['wa_paper']:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
