"""Time the latent form of the tiered decode (`latent_decode.cu`) on the
card, for one checkout of the port or for two side by side.

    python3 scripts/bench_latent_torch.py [--src DIR] [--label NAME]

`--src` names the `src/` directory whose `repro_torch` is timed (default:
this checkout's), so a parent commit unpacked beside the change is timed
by the same code: run parent, change, change, parent in one call. Two
shapes: deepseek-v2-lite's decode (B 4, H 16, r 512, p 64, group 64,
dense_len 2048, the wrapper's split plan) and the reduced deepseek's
rank (B 4, H 4, r 32, p 16, group 16, dense_len 2048), the latter only
where the checkout's kernel takes r 32 (else the line says it was
refused). Per shape: the device time of back-to-back launches (a CUDA
graph of 20: `device_ms`), the mean of CUDA events around each launch
(`ms`), the bytes bound, and the largest difference from the plain
version over the max |output|. The timers and the card's line are
`chip_smoke.py`'s (`graph_ms`, `kernel_ms`). Prints the card's name and
power limit, then one JSON line per measurement.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = (  # (label, B, H, r, p, group, dense_len)
    ("deepseek decode", 4, 16, 512, 64, 64, 2048),
    ("deepseek reduced rank", 4, 4, 32, 16, 16, 2048),
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs     # puts this checkout's src/ first: --src
    sys.path.insert(0, os.path.abspath(args.src))   # goes before it
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device")
    cs._card_line()
    from repro_torch.kernels.ips_repack.ref import quantize_rows_ref
    from repro_torch.kernels.tiered_attention import ops
    from repro_torch.kernels.tiered_attention.ref import (
        latent_tier_partial_ref)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(32)

    def emit(obj):
        print(json.dumps({"label": args.label, "src": args.src,
                          "card": cs.CARD, **obj}, sort_keys=True), flush=True)

    for name, b, h, r, p, group, dense_len in SHAPES:
        s = dense_len
        c4, sc = quantize_rows_ref(2.0 * torch.randn(
            (b * s, r), generator=gen, device=dev), group)
        tier = (torch.randn((b, h, r), generator=gen, device=dev).to(
                    torch.bfloat16).float(),
                torch.randn((b, h, p), generator=gen, device=dev).to(
                    torch.bfloat16).float(),
                c4.reshape(b, s, r // 2),
                sc.reshape(b, s, r // group).to(torch.bfloat16),
                torch.randn((b, s + 1024, p), generator=gen,
                            device=dev).to(torch.bfloat16))
        scale = 1.0 / 192 ** 0.5

        def call():
            return ops.latent_tier_partial(*tier, dense_len, group=group,
                                           scale=scale)
        shape = {"shape": name, "B": b, "H": h, "r": r, "p": p,
                 "group": group, "dense_len": dense_len}
        try:
            got = call()
        except ValueError as e:
            emit({**shape, "refused": str(e)})
            continue
        want = latent_tier_partial_ref(*tier, dense_len, group, scale)
        err = max(float((a - w).abs().max()) / max(float(w.abs().max()),
                                                   1e-30)
                  for a, w in zip(got, want))
        moved = b * dense_len * (r // 2 + (r // group) * 2 + p * 2)
        emit({**shape, "device_ms": cs.graph_ms(call),
              "ms": cs.kernel_ms(ops.LATENT_LAUNCHER, call),
              "bound_ms": moved / cs.HBM_BYTES_PER_S * 1e3,
              "max_err_over_max_abs": err,
              "split_plan": list(ops.latent_split_plan(dense_len, b))})
    return 0


if __name__ == "__main__":
    sys.exit(main())
