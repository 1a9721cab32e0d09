"""Time the flash forward (`flash_attention/csrc/flash_fwd.cu`, its bf16
form) on the card, for one checkout of the port or for two side by side.

    python3 scripts/bench_flash_fwd_torch.py [--src DIR] [--label NAME]

`--src` names the `src/` directory whose `repro_torch` is timed (default:
this checkout's), so another form of the kernel unpacked beside this one
is timed by the same code: `git archive <commit> | tar -x -C
build/parent`, then run this checkout, `--src build/parent/src`, the
parent again and this checkout again in one call.

Shapes, bf16, random from a seed: the serving prefills that
`chip_smoke.py` holds the kernel to (B 4, S 2048: gemma-2b H 8, Hkv 1,
hd 256; zamba2-1.2b H 32, Hkv 32, hd 64; arctic-480b H 56, Hkv 8, hd
128; whisper-tiny H 6, Hkv 6, hd 64; llava-next-34b S 2624, arctic's
heads), MLA's (deepseek-v2-lite: H 16, q and k 192, v 128, through the
wrapper as a user calls it: a checkout without the MLA form pads to 256),
gemma-2b's training shape (B 2) and train_lm's (`examples/
train_lm_torch.py` at its ~100M flags: B 32, S 512, H 12, Hkv 6, hd 64).
Per shape: the device time of back-to-back wrapper calls (a CUDA graph
of 20: `device_ms`, padding included where the wrapper pads), the mean
of CUDA events around each launch (`ms`), the same two for PyTorch's
`scaled_dot_product_attention(is_causal)` forward on the same inputs
(`sdpa_device_ms`, `sdpa_ms`: events around 20 calls, host gaps
included), the operations bound (unpadded widths) and the largest
difference of out from the float32 plain version (`ref.flash_ref`) over
its max |out|. Then each bf16 instantiation's registers and spill bytes
as ptxas reported them (when this process built the library) and any
ptxas line about `wgmma`. The timers, the bound and the card's line are
`chip_smoke.py`'s. Prints the card's name and power limit, then one JSON
line per measurement.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = (  # (label, B, S, H, Hkv, hd, hd_v)
    ("gemma-2b", 4, 2048, 8, 1, 256, 256),
    ("zamba2-1.2b", 4, 2048, 32, 32, 64, 64),
    ("arctic-480b", 4, 2048, 56, 8, 128, 128),
    ("whisper-tiny", 4, 2048, 6, 6, 64, 64),
    ("llava-next-34b", 4, 2624, 56, 8, 128, 128),
    ("mla", 4, 2048, 16, 16, 192, 128),
    ("gemma-2b training", 2, 2048, 8, 1, 256, 256),
    ("train_lm", 32, 512, 12, 6, 64, 64),
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
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device")
    cs._card_line()
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_ref
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(30)

    def emit(obj):
        print(json.dumps({"label": args.label, "src": args.src,
                          "card": cs.CARD, **obj}, sort_keys=True), flush=True)

    for name, b, s, h, hkv, hd, hd_v in SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for shape in ((b, s, h, hd), (b, s, hkv, hd),
                                          (b, s, hkv, hd_v)))
        scale = 1.0 / hd ** 0.5

        def call(q=q, k=k, v=v, scale=scale):
            return ops.flash_fwd(q, k, v, scale=scale)
        want = flash_ref(q, k, v, chunk=512, scale=scale)[0]
        err = float((call()[0] - want).abs().max()) / float(
            want.abs().max())
        del want
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa(qt=qt, kt=kt, vt=vt, scale=scale, gqa=h != hkv):
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=scale, enable_gqa=gqa)
        bound, by = cs.flash_bound(b, s, h, hkv, hd, 2, hd_v)
        emit({"shape": name, "B": b, "S": s, "H": h, "Hkv": hkv, "hd": hd,
              "hd_v": hd_v, "device_ms": cs.graph_ms(call),
              "ms": cs.kernel_ms(ops.LAUNCHER, call),
              "sdpa_device_ms": cs.graph_ms(sdpa),
              "sdpa_ms": cs.time_ms(sdpa, cs.TIMED),
              "bound_ms": bound, "bound_by": by,
              "max_err_over_max_abs": err})
    emit({"ptxas_by_kernel": {cs._short_kernel_name(n): r for n, r in
                              ops.LIB.ptxas_by_kernel().items()
                              if "wgmma" in n},
          "ptxas_wgmma_lines": [ln.strip() for ln in
                                ops.LIB.build_log.splitlines()
                                if "wgmma" in ln and "Compiling" not in ln]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
