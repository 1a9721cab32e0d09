#!/usr/bin/env python3
"""Phase 13 of `chip_smoke.py` alone: the distribution phase on the card,
run as the full script runs it (the paper grid over 4 ranks and the
quick search over 2, `compressed_psum` over 4 ranks and on a 1-rank
NCCL group, gemma-2b's train state saved by 2 ranks and restored by one
process and by 4, the plan's memory, the three planted faults). A
diagnostic: it prints the card's line, the phase's JSON lines and its
wall, and no kernel table or result line; a check that fails ends the
run, as in `chip_smoke.py`.

    python3 scripts/dist_phase.py
"""
from __future__ import annotations

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
    cs.distribution_phase(torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
