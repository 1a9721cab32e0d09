#!/usr/bin/env python3
"""Phase 12 of `chip_smoke.py` alone: training on the card, run as the
full script runs it (gemma-2b and mamba2-370m at full size, their
kernels' gradients against the plain versions', the planted faults, the
training launcher, the checkpoint round trip). A diagnostic: it prints
the card's line, the phase's JSON lines and its wall, and no kernel
table or result line; a check that fails ends the run, as in
`chip_smoke.py`.

    python3 scripts/train_phase.py
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
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.ssd_scan import ops as ssd
    build_all([flash.LIB, ssd.LIB])
    cs.training_phase(torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
