"""Time the flash backward (`flash_attention/csrc/flash_bwd.cu`) on the
card, for one checkout of the port or for two side by side.

    python3 scripts/bench_flash_bwd_torch.py [--src DIR] [--label NAME]

`--src` names the `src/` directory whose `repro_torch` is timed (default:
this checkout's), so another form of the kernel unpacked beside this one
is timed by the same code: run one, the other, the other, the first in
one call. Three training shapes, bf16, dout bf16-exact as the bf16
model's is: gemma-2b's (B 2, S 2048, H 8, Hkv 1, hd 256), train_lm's
(`examples/train_lm_torch.py` at its ~100M flags: B 32, S 512, H 12, Hkv
6, hd 64) and MLA's (deepseek-v2-lite: B 2, S 2048, H = Hkv = 16, q and
k 192, v 128, zero-padded to 256). Per shape and bf16 term count (1, 2,
3): the device time of back-to-back launches (a CUDA graph of 20:
`device_ms`), the mean of CUDA events around each launch (`ms`), the
operations bound, and the largest difference of dq, dk and dv from the
plain version over each one's max |value|. Per shape also the device ms
a launch of each of its kernels at 3 terms (the prologue, the two
passes, the group sum) from `torch.profiler`, and the yardstick: the
backward of PyTorch's `scaled_dot_product_attention(is_causal)` (each
backend alone, keys and values expanded; MLA's at its unpadded widths),
and at gemma's shape `flash_fwd` beside SDPA's forward. The timers, the
bound, the yardsticks and the card's line are `chip_smoke.py`'s. Prints the card's
name and power limit, then one JSON line per measurement.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = (  # (label, B, S, H, Hkv, hd, hd_v)
    ("gemma-2b", 2, 2048, 8, 1, 256, 256),
    ("train_lm", 32, 512, 12, 6, 64, 64),
    ("mla", 2, 2048, 16, 16, 192, 128),
)
TERMS = (1, 2, 3)


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
    from repro_torch.kernels.flash_attention.ref import flash_bwd_ref
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(26)

    def emit(obj):
        print(json.dumps({"label": args.label, "src": args.src,
                          "card": cs.CARD, **obj}, sort_keys=True), flush=True)

    for name, b, s, h, hkv, hd, hd_v in SHAPES:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        q = randn(b, s, h, hd).to(torch.bfloat16)
        k = randn(b, s, hkv, hd).to(torch.bfloat16)
        v = randn(b, s, hkv, hd_v).to(torch.bfloat16)
        dout = randn(b, h, s, hd_v).to(torch.bfloat16).float()
        width = next(w for w in ops.HEAD_DIMS if w >= max(hd, hd_v))
        lib = {"shape": name, "sdpa_backward": cs.sdpa_backward_ms(
            q, k, v, dout, h // hkv)}
        if name == "gemma-2b":
            lib["flash_fwd"] = cs.flash_fwd_training_ms(q, k, v)
        emit(lib)
        q, k, v, dout = (F.pad(t, (0, width - t.shape[-1]))
                         for t in (q, k, v, dout))
        scale = 1.0 / hd ** 0.5
        out, lse = ops.flash_fwd(q, k, v, scale=scale)
        inputs = (q, k, v, out, lse, dout)
        want = flash_bwd_ref(*inputs, scale=scale, chunk=512)
        bound, by = cs.flash_bwd_bound(b, s, h, hkv, hd, 2, hd_v)
        for terms in TERMS:
            def call(terms=terms):
                return ops.flash_bwd(*inputs, scale=scale, terms=terms)
            err = max(float((a.float() - w.float()).abs().max())
                      / float(w.float().abs().max())
                      for a, w in zip(call(), want))
            emit({"shape": name, "B": b, "S": s, "H": h, "Hkv": hkv,
                  "hd": hd, "hd_v": hd_v, "terms": terms,
                  "device_ms": cs.graph_ms(call),
                  "ms": cs.kernel_ms(ops.BWD_LAUNCHER, call),
                  "bound_ms": bound, "bound_by": by,
                  "max_err_over_max_abs": err})
        emit({"shape": name, "split_ms": kernel_split(
            lambda: ops.flash_bwd(*inputs, scale=scale))})
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
    path = os.path.join(ROOT, "build", "bench_flash_bwd_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    os.remove(path)
    ms, count = {}, {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memset"):
            name = str(e.get("name", "")).replace(
                "(anonymous namespace)::", "").replace("void ", "")
            name = name.split("(")[0][:60]
            ms[name] = ms.get(name, 0.0) + float(e.get("dur", 0)) / 1e3
            count[name] = count.get(name, 0) + 1
    return {name: total / count[name] for name, total in ms.items()}


if __name__ == "__main__":
    sys.exit(main())
