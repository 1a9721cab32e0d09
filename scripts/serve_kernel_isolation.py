#!/usr/bin/env python3
"""Which kernel moves a served model's logits away from its plain
version, and how steady a path's check is: one serving path of
`chip_smoke.py`, run as the full script runs it, with its plain run
keeping one kernel (that kernel's wrapper is not replaced by its plain
version), so that the kernel run and the plain run differ by every other
kernel's departure alone. The floor run keeps it too. `--keep none` is
the path exactly as `chip_smoke.py` checks it. A check that fails ends
the run, as in `chip_smoke.py`.

    python3 scripts/serve_kernel_isolation.py --arch llava-next-34b \\
        --layers 32 --keep flash_fwd --keep tiered_decode --keep none
    python3 scripts/serve_kernel_isolation.py --arch llava-next-34b \\
        --layers 32 --keep none --repeat 3

Each `--keep` is one run of the path, in the order given, the whole list
`--repeat` times in one process. Prints `chip_smoke.py`'s serve lines,
each with the floor's rms and the error's rms at every decode step and
their largest ratio, and after each run a line with its wall.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KEEPABLE = ("flash_fwd", "ips_repack", "tiered_decode", "latent_decode",
            "ssd_intra", "none")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--policy", default="IPS")
    ap.add_argument("--keep", action="append", choices=KEEPABLE,
                    required=True)
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args(argv)

    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: the diagnostic runs the kernels")
    cs._card_line()
    from repro_torch.kernels._build import build_all
    build_all([lib for _, lib in cs.serving_libraries()])

    cuda = torch.device("cuda", 0)
    for run in range(args.repeat):
        for keep in args.keep:
            t1 = time.perf_counter()
            cs.serve_main_path(cuda, args.arch, args.layers, (args.policy,),
                               keep=None if keep == "none" else keep)
            torch.cuda.empty_cache()
            cs.emit({"phase": "isolation_run", "arch": args.arch,
                     "layers": args.layers, "policy": args.policy,
                     "keep": keep, "run": run + 1, "of": args.repeat,
                     "wall_s": time.perf_counter() - t1})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
