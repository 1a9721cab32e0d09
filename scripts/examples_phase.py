#!/usr/bin/env python3
"""Phase 14 of `chip_smoke.py` alone: the port's examples and dev
scripts on the card, run as the full script runs them (each `main` in
this process, its printed table against the reference examples'
recorded output, train_lm at ~100M with a resume, smoke_models over
every arch, yi-6b and minitron-4b served at full width). A diagnostic:
it prints the card's line, the phase's JSON lines and its wall, and no
kernel table or result line; a check that fails ends the run, as in
`chip_smoke.py`.

    python3 scripts/examples_phase.py
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: the diagnostic runs the kernels")
    cs._card_line()
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.host_tier import ops as host_tier
    from repro_torch.kernels.ssd_step import ops as ssd_step
    build_all([ssd_step.LIB, host_tier.LIB]
              + [lib for _, lib in cs.serving_libraries()])
    os.environ["REPRO_TORCH_TRACE_CACHE_DIR"] = os.path.join(
        ROOT, "build", "trace_cache")
    with open(os.path.join(ROOT, "BENCH_sweep_paper.json")) as f:
        bench = json.load(f)
    cs.examples_phase(torch.device("cuda", 0), bench)
    return 0


if __name__ == "__main__":
    sys.exit(main())
