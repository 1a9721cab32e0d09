"""Where a consumer warpgroup of the flash forward's bf16 form spends its
turns (a diagnostic: no kernel table, no result line).

    python3 scripts/profile_flash_fwd_torch.py

It copies `flash_attention/csrc/flash_fwd.cu` into `build/profile_flash/`
with `clock64()` stamps at each step of a turn (data landed, its turn to
issue, products issued, S landed, softmax done, P V landed, split done)
and at each work item's start and end, written by lane 0 of warp 0 of
each consumer warpgroup of block 0 through predicated stores (a branch
while a product is in flight would serialize every `wgmma`). It builds
the copy with the port's nvcc flags, runs it at gemma-2b's (hd 256),
zamba2-1.2b's (hd 64) and arctic-480b's (hd 128) prefill shapes (inputs
from a seed) and prints, per warpgroup, the mean cycles of each step over
the turns of block 0's items, and the items' cycles. The stamps' anchors
are strings of the kernel's source, so an edit there fails this script
loudly rather than stamping the wrong place. Prints the card's name and
power limit first.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels",
                      "flash_attention", "csrc", "flash_fwd.cu")
OUT = os.path.join(ROOT, "build", "profile_flash")
SHAPES = (  # (label, B, S, H, Hkv, hd)
    ("gemma-2b", 4, 2048, 8, 1, 256),
    ("zamba2-1.2b", 4, 2048, 32, 32, 64),
    ("arctic-480b", 4, 2048, 56, 8, 128),
)
N = 16384                       # stamps a warpgroup
# (the source text a stamp follows, its step)
STEPS = (
    ("    c.wait_full(kRingVF, t - 1);\n    turn_wait(c.mine());\n",
     "its turn (after its tiles landed)"),
    ("    turn_pass(c.theirs());                            // a last turn "
     "follows\n", "products issued"),
    ("    fence_regs(s);\n    c.release(kRingKE, t, true);\n", "S landed"),
    ("    softmax<HDQ, HDV, MASKED>(s, c, t, st, c0, c1);\n", "softmax"),
    ("    fence_regs(pt);\n    c.release(kRingVE, t - 1, true);\n",
     "P V landed"),
    ("    split<Tile<HDQ, HDV>::BN>(s, pt);\n", "rescale, split"),
)
DATA = "    c.wait_full(kRingKF, t);\n    c.wait_full(kRingVF, t - 1);\n"
ITEM_START = "            if (T::QREGS) load_q<HDQ, HDV>(qf, c);\n"
ITEM_END = "            const Item it = item_of(item_index(rr), H, B, nq);\n"
STAMPS = f'''
__device__ unsigned long long g_tl[2][{N}];
__shared__ unsigned g_tn[2];
// lane 0 of warp 0 of each consumer warpgroup of block 0 stamps step k
// and the clock, by predicated stores: no branch
__device__ __forceinline__ void stamp(unsigned k) {{
    const unsigned w = (threadIdx.x >> 7) & 1, i = g_tn[w];
    const unsigned long long v =
        (static_cast<unsigned long long>(k) << 56)
        | (static_cast<unsigned long long>(clock64()) & ((1ull << 56) - 1));
    const unsigned on = blockIdx.x == 0 && (threadIdx.x & 127) == 0
                        && i < {N};
    asm volatile("{{\\n.reg .pred p;\\nsetp.ne.u32 p, %2, 0;\\n"
                 "@p st.global.u64 [%0], %1;\\n"
                 "@p st.shared.u32 [%3], %4;\\n}}\\n"
                 :: "l"(&g_tl[w][i % {N}]), "l"(v), "r"(on),
                    "r"(static_cast<unsigned>(__cvta_generic_to_shared(
                        &g_tn[w]))), "r"(i + 1) : "memory");
}}
'''
READ = f'''
extern "C" int prof_read(unsigned long long* out) {{
    return (int)cudaMemcpyFromSymbol(out, g_tl, sizeof(g_tl));
}}
'''


def _after(src: str, anchor: str, text: str) -> str:
    """`text` inserted after the one place `anchor` stands."""
    if src.count(anchor) != 1:
        raise SystemExit(f"profile: the anchor {anchor!r} is no longer in "
                         "the kernel's source once")
    at = src.index(anchor) + len(anchor)
    return src[:at] + text + src[at:]


def patched() -> str:
    """The kernel's source with the stamps."""
    src = open(SOURCE).read()
    src = src.replace("namespace {\n", "namespace {\n" + STAMPS, 1)
    src = _after(src, "        mbar_init(bar_qe, 4 * kConsumers);"
                 "            // one a warp\n",
                 "        g_tn[0] = 0;\n        g_tn[1] = 0;\n")
    for k, (anchor, _) in enumerate(STEPS):
        src = _after(src, anchor, f"    stamp({k + 1});\n")
    src = _after(src, DATA, "    stamp(0);\n")
    src = _after(src, ITEM_START, "            stamp(8);\n")
    src = _after(src, ITEM_END, "            stamp(9);\n")
    return src + READ


def main() -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs     # puts this checkout's src/ first
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile: no CUDA device")
    cs._card_line()
    from repro_torch.kernels._build import BASE_FLAGS, LINK_FLAGS, nvcc
    os.makedirs(OUT, exist_ok=True)
    cu, so = os.path.join(OUT, "prof.cu"), os.path.join(OUT, "libprof.so")
    with open(cu, "w") as f:
        f.write(patched())
    built = subprocess.run([nvcc(), *BASE_FLAGS, *LINK_FLAGS, "-o", so, cu],
                           capture_output=True, text=True)
    if built.returncode:
        raise SystemExit(built.stderr[-5000:])
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_fwd.argtypes = [p, p, p, i, p, p, i, i, i, i, i, i,
                              ctypes.c_float, p]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(30)
    names = ["its tiles landed"] + [name for _, name in STEPS]
    for label, b, s, h, hkv, hd in SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for shape in ((b, s, h, hd), (b, s, hkv, hd),
                                          (b, s, hkv, hd)))
        out = torch.empty((b, h, s, hd), device=dev)
        lse = torch.empty((b, h, s), device=dev)

        def call():
            rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), 1,
                               out.data_ptr(), lse.data_ptr(), b, s, h, hkv,
                               hd, hd, hd ** -0.5,
                               torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise SystemExit(f"profile: flash_fwd returned {rc}")
        call()
        torch.cuda.synchronize()
        call()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (2 * N))()
        lib.prof_read(buf)
        print(f"{label} (B {b}, S {s}, H {h}, Hkv {hkv}, hd {hd}):")
        for wg in range(2):
            marks = [(int(x) >> 56, int(x) & ((1 << 56) - 1))
                     for x in buf[wg * N:(wg + 1) * N] if x]
            steps = [[] for _ in names]
            items, start, prev = [], None, None
            for kind, clk in marks:
                if kind == 8:
                    start = clk
                elif kind == 9 and start is not None:
                    items.append(clk - start)
                elif kind <= 6:
                    if prev is not None:
                        steps[kind].append(clk - prev)
                    prev = clk
                if kind in (8, 9):
                    prev = None
            turns = len(steps[1])
            total = sum(sum(x) for x in steps)
            print(f"  warpgroup {wg}: {len(items)} items, "
                  f"{sum(items) / max(1, len(items)):.0f} cycles an item; "
                  f"{turns} middle turns, {total / max(1, turns):.0f} "
                  "cycles a turn from its tiles landing:")
            for name, xs in zip(names, steps):
                if xs:
                    print(f"    {name:34s} {sum(xs) / len(xs):8.0f} "
                          f"({100 * sum(xs) / max(1, total):.1f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
