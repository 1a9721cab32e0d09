"""Time the SSD intra-chunk backward (`ssd_scan/csrc/ssd_intra_bwd.cu`) on
the card, for one checkout of the port or for two side by side.

    python3 scripts/bench_ssd_bwd_torch.py [--src DIR] [--label NAME]

`--src` names the `src/` directory whose `repro_torch` is timed (default:
this checkout's), so another form of the kernel unpacked beside this one
is timed by the same code: run one, the other, the other, the first in
one call. Two training shapes, float32, chunks of 256: mamba2-370m's (Bt
2, nc 8, nh 32, hd 64, N 128) and zamba2-1.2b's (nh 64, N 64), the
inputs and cotangents random from a seed. Per shape: the device time of
back-to-back launches (a CUDA graph of 20: `device_ms`), the mean of
CUDA events around each launch (`ms`), the device ms a launch of each of
its kernels (the passes) from `torch.profiler`, the operations bound,
and the largest difference of each gradient from the plain version
(`ref.intra_chunk_bwd_ref`) over its max |value|. No PyTorch call
computes this gradient: no library time. The timers, the bound and the
card's line are `chip_smoke.py`'s. Prints the card's name and power
limit, then one JSON line per shape.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = (  # (label, Bt, nc, Q, nh, hd, N)
    ("mamba2-370m", 2, 8, 256, 32, 64, 128),
    ("zamba2-1.2b", 2, 8, 256, 64, 64, 64),
)
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs     # puts this checkout's src/ first: --src
    sys.path.insert(0, os.path.abspath(args.src))   # goes before it
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device")
    cs._card_line()
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import intra_chunk_bwd_ref
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(29)

    for name, bt, nc, q, nh, hd, n in SHAPES:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        ins = (randn(bt, nc, q, nh, hd), F.softplus(randn(bt, nc, q, nh)),
               -torch.exp(0.3 * randn(nh)), randn(bt, nc, q, n),
               randn(bt, nc, q, n), randn(bt, nc, q, nh, hd),
               randn(bt, nc, nh, hd, n), randn(bt, nc, q, nh))

        def call():
            return ops.ssd_intra_bwd(*ins)
        want = intra_chunk_bwd_ref(*ins)
        err = {nm: float((g - w).abs().max() / w.abs().max())
               for nm, g, w in zip(NAMES, call(), want)}
        del want
        bound, by = cs.ssd_intra_bwd_bound(bt, nc, q, nh, hd, n)
        print(json.dumps({
            "label": args.label, "src": args.src, "card": cs.CARD,
            "shape": name, "Bt": bt, "nc": nc, "Q": q, "nh": nh, "hd": hd,
            "N": n, "device_ms": cs.graph_ms(call),
            "ms": cs.kernel_ms(ops.BWD_LAUNCHER, call),
            "pass_ms": kernel_split(call), "bound_ms": bound,
            "bound_by": by, "max_err_over_max_abs": err}, sort_keys=True),
            flush=True)
    return 0


def kernel_split(fn, n: int = 10) -> dict:
    """Device ms a launch of each kernel that `fn` launches, by name: n
    calls under `torch.profiler` (after one call outside it), each name's
    time over its own recorded launches (the profiler may drop some)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ms, count = {}, {}
    for ev in prof.key_averages():
        if ev.device_time_total <= 0:
            continue
        name = ev.key.replace("(anonymous namespace)::", "").replace(
            "void ", "").split("(")[0][:60]
        ms[name] = ms.get(name, 0.0) + ev.device_time_total / 1e3
        count[name] = count.get(name, 0) + ev.count
    return {name: total / max(count[name], 1) for name, total in ms.items()}


if __name__ == "__main__":
    sys.exit(main())
