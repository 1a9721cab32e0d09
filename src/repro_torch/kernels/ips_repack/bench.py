"""Time the `ips_repack` kernel on the card, cold, at the serving path's
shapes, for one checkout of the port or for two side by side.

    python src/repro_torch/kernels/ips_repack/bench.py [--src DIR]
        [--label NAME]

`--src` names the `src/` directory whose `repro_torch` is timed (default:
this checkout's), so a parent commit unpacked beside the change is timed
by the same code: run parent, change, change, parent in one call. The
forms both versions have are timed in both (`quantize_rows`, the tier
form with float32 scales, at gemma-2b's prefill fill, 73,728 x 256 bf16;
`repack_arena` at 128 pages of 256 x 1024); the in-place form
(`quantize_into`) where the checkout has it. Each launch runs with the L2
cache cold: a read of 512 MiB (after the copy that restores the arena's
pages) runs just before it, leaving the L2 full of clean lines and
keeping the card busy while the host issues the launch, so the CUDA
events around the launch read the kernel's device time. `warm_ms` is the
device time of back-to-back launches on the same input (a CUDA graph of
20). One profiled launch of each form reports what
`torch.profiler` records of the kernel (grid, block, registers, shared
memory, estimated occupancy). A device-to-device copy of the tier form's
input is the memory yardstick. Prints one JSON line per measurement with
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

HBM_BYTES_PER_S = 3.35e12
GROUP = 64
FILL_ROWS = 18 * 4 * 1024          # gemma-2b: 18 layers x B 4 x 1024 tokens
ARENA = (128, 256, 1024)            # pages, tokens, feat
TIMED = 20


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else "nvidia-smi: no output"


def warm_ms(fn, n: int = TIMED) -> float:
    """Mean device ms of fn() over n calls captured in one CUDA graph."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def cold_ms(fn, before, n: int = TIMED) -> float:
    """Mean ms of fn() with `before()` (a copy past the L2) run just
    before each launch, outside the events."""
    import torch
    fn()
    times = []
    for _ in range(n):
        before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in times) / n


def profiled(fn) -> list:
    """What torch.profiler records of the kernels fn() launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    os.remove(path)
    keys = ("grid", "block", "registers per thread", "shared memory",
            "blocks per SM", "warps per SM", "est. achieved occupancy %")
    return [{"kernel": e["name"][:60], "device_us": e.get("dur"),
             **{k: e["args"][k] for k in keys if k in e.get("args", {})}}
            for e in trace.get("traceEvents", [])
            if e.get("cat") == "kernel"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device")
    from repro_torch.kernels.ips_repack import ops
    card, dev = _card(), torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)

    def emit(obj):
        print(json.dumps({"label": args.label, "src": args.src,
                          "card": card, **obj}, sort_keys=True), flush=True)

    flush_buf = torch.ones(128 << 20, dtype=torch.float32, device=dev)

    def flush():
        flush_buf.sum()
    x = (3.0 * torch.randn((FILL_ROWS, 256), generator=gen, device=dev)
         ).to(torch.bfloat16)
    y = torch.empty_like(x)
    nbytes = x.numel() * 2
    ms = cold_ms(lambda: y.copy_(x), flush)
    emit({"form": "copy (yardstick)", "shape": list(x.shape), "ms": ms,
          "bytes": 2 * nbytes, "gb_s": 2 * nbytes / ms / 1e6})

    moved = nbytes + nbytes // 4 + FILL_ROWS * (256 // GROUP) * 4
    ms = cold_ms(lambda: ops.quantize_rows(x, GROUP), flush)
    emit({"form": "tier, float32 scales (quantize_rows)",
          "shape": list(x.shape), "ms": ms,
          "warm_ms": warm_ms(lambda: ops.quantize_rows(x, GROUP)),
          "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
          "profile": profiled(lambda: ops.quantize_rows(x, GROUP))})

    if hasattr(ops, "quantize_into"):
        packed = torch.empty((FILL_ROWS, 128), dtype=torch.uint8, device=dev)
        sc = torch.empty((FILL_ROWS, 256 // GROUP), dtype=torch.bfloat16,
                         device=dev)
        moved = nbytes + nbytes // 4 + FILL_ROWS * (256 // GROUP) * 2

        def into():
            ops.quantize_into([(x[None, None], packed[None, None],
                                sc[None, None])], 0, GROUP)
        ms = cold_ms(into, flush)
        emit({"form": "tier, bf16 scales (quantize_into)",
              "shape": list(x.shape), "ms": ms, "warm_ms": warm_ms(into),
              "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
              "profile": profiled(into)})

    pages, tokens, feat = ARENA
    page_bytes = tokens * feat * 2 + 4096
    orig = torch.randint(0, 256, (pages, page_bytes), dtype=torch.uint8,
                         generator=gen, device=dev)
    orig[:, :tokens * feat * 2] = (2.0 * torch.randn(
        (pages, tokens * feat), generator=gen, device=dev)).to(
        torch.bfloat16).view(torch.uint8)
    arena = orig.clone()

    def arena_call():
        ops.repack_arena(arena, tokens=tokens, feat=feat, group=GROUP)
    moved = pages * (tokens * feat * 2 + tokens * feat // 2
                     + tokens * (feat // GROUP) * 2)
    ms = cold_ms(arena_call, lambda: (arena.copy_(orig), flush()))
    emit({"form": "arena", "pages": pages, "tokens": tokens, "feat": feat,
          "ms": ms, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
          "profile": profiled(arena_call)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
