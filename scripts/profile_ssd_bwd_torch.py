"""Where the SSD backward's `wgmma` head pass spends its cycles, by phase
(a diagnostic: no kernel table, no result line).

    python3 scripts/profile_ssd_bwd_torch.py

It copies `ssd_scan/csrc/ssd_intra_bwd.cu` into `build/profile_ssd_bwd/`
with `clock64()` counters added after each phase of
`ssd_intra_bwd_heads_wg` (thread 0 of every block adds its cycles to a
device array) and, in the chunk launch, each block kind's slowest and
summed cycles. It builds the copy with the port's nvcc flags, runs it at
mamba2-370m's and zamba2-1.2b's training shapes (inputs from a seed) and
prints, per phase, the cycles a block, a head or a row tile spends and
its share. The counters cost a few percent; the phases' anchors are
strings of the kernel's source, so an edit there fails this script
loudly rather than counting the wrong span. Prints the card's name and
power limit first.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "ssd_scan",
                      "csrc", "ssd_intra_bwd.cu")
OUT = os.path.join(ROOT, "build", "profile_ssd_bwd")
SHAPES = (  # (label, Bt, nc, Q, nh, hd, N)
    ("mamba2-370m", 2, 8, 256, 32, 64, 128),
    ("zamba2-1.2b", 2, 8, 256, 64, 64, 64),
)
# (the source lines a counter follows, or stands between where they hold
# a "|", the phase it closes, counted per)
PHASES = (
    ("    issue_dst(h0);\n", "prologue", "block"),
    ("        land(bar_l, ph_l);               // x_j, cum and dt\n"
     "        __syncthreads();\n", "land x, cum, dt", "head"),
    ("        __syncthreads();                 // the planes; the landing "
     "tile free\n", "split x", "head"),
    ("        land(bar_d, ph_d);               // dst\n", "land dst", "head"),
    ("        wg_product<N, 0>(dxa, Df, LDD, 0, 0, bp, jh, L::PB_B);\n",
     "B dst^T", "head"),
    ("        __syncthreads();                 // dst and w x_j read\n",
     "dw, dB's term", "head"),
    ("        // registers; dx^T += dy_i^T S\n        land(bar_l, ph_l);\n",
     "first dy landed", "head"),
    ("            __syncthreads();             // dy_i's planes; the "
     "landing free\n", "split dy", "tile"),
    ("            wg_product<HD, 3>(acc, nullptr, 0, yp, 0, xp, jh, "
     "L::PB_X);\n", "dS", "tile"),
    ("                    acc[4 * n8 + e] = in ? __fmul_rn(t1, el) : 0.0f;\n"
     "                }\n", "epilogue", "tile"),
    ("                cp[4 * kT] = __fadd_rn(cp[4 * kT], "
     "reduce_scatter8(qc));\n            }\n", "stores, sums", "tile"),
    ("            __syncthreads();             // S^T's planes and row "
     "sums\n", "barrier", "tile"),
    ("            for (int k = 0; k < 8; ++k) fence_frag(a4[k]);\n",
     "dx^T (and the next tile's reads)", "tile"),
    ("            __syncthreads();             // dy_i's and S^T's planes "
     "read\n", "barrier", "tile"),
    ("        __syncthreads();                 // the partial sums read\n"
     "|    }\n\n    // the group's dB partial: db holds dB^T",
     "dx stores, finish a head", "head"),
)
COUNTERS = '''
__device__ unsigned long long g_prof[32];
#define PROF(k) do { if (threadIdx.x == 0) { long long now_ = clock64(); \\
    atomicAdd(&g_prof[k], (unsigned long long)(now_ - tprev_)); \\
    tprev_ = now_; } } while (0)
#define PROF_MAX(k) do { if (threadIdx.x == 0) { \\
    unsigned long long d_ = clock64() - c0_; atomicMax(&g_prof[k], d_); \\
    atomicAdd(&g_prof[(k) + 3], d_); } } while (0)
'''
READ = '''
extern "C" int prof_read(unsigned long long* out) {
    return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
extern "C" int prof_reset() {
    unsigned long long z[32] = {0};
    return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
'''


def _after(src: str, anchor: str, text: str) -> str:
    """`text` inserted after the one place `anchor` stands (at its "|",
    if it has one)."""
    pre, _, post = anchor.partition("|")
    if src.count(pre + post) != 1:
        raise SystemExit(f"profile: the anchor {anchor!r} is no longer in "
                         "the kernel's source once")
    at = src.index(pre + post) + len(pre)
    return src[:at] + text + src[at:]


def patched() -> str:
    """The kernel's source with the counters."""
    src = open(SOURCE).read()
    src = src.replace("namespace {\n", "namespace {\n" + COUNTERS, 1)
    src = _after(src, "    using L = WgL<HD, N>;\n",
                 "    long long tprev_ = clock64();\n")
    for k, (anchor, _, _) in enumerate(PHASES):
        last = anchor.partition("|")[0].splitlines()[-1]
        indent = last[:len(last) - len(last.lstrip())]
        src = _after(src, anchor, f"{indent}PROF({k});\n")
    # the chunk launch: finish blocks (20), dC (21), dB (22); sums at +3
    at = src.index("ssd_intra_bwd_chunk(const float* __restrict__ Bm,")
    smem = "    extern __shared__ __align__(16) float smem[];\n"
    at = src.index(smem, at) + len(smem)
    src = src[:at] + "    long long c0_ = clock64();\n" + src[at:]
    src = _after(src, "                    static_cast<int>(blockIdx.x - "
                 "tiles), smem);\n", "        PROF_MAX(20);\n")
    src = _after(src, "                        make_float2(acc[n8][2 * half], "
                 "acc[n8][2 * half + 1]);\n            }\n        }\n",
                 "        PROF_MAX(21);\n")
    end = src.index("// ---------------------------------------------------"
                    "------------------------\n// launch", at)
    close = src.rindex("}\n", 0, end)
    src = src[:close] + "    PROF_MAX(22);\n" + src[close:]
    return src + READ


def main() -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs     # puts this checkout's src/ first
    import torch
    import torch.nn.functional as F
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
    lib.ssd_intra_bwd.argtypes = [p] * 14 + [i] * 5 + [p]
    lib.ssd_intra_bwd_work.argtypes = [i] * 4
    lib.ssd_intra_bwd_work.restype = ctypes.c_longlong
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
        outs = [torch.empty_like(t) for t in ins[:5]]
        work = torch.empty(lib.ssd_intra_bwd_work(bt * nc, q, nh, n),
                           device=dev)

        def call():
            rc = lib.ssd_intra_bwd(
                *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
                work.data_ptr(), bt * nc, q, nh, hd, n,
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise SystemExit(f"profile: ssd_intra_bwd returned {rc}")
        call()
        torch.cuda.synchronize()
        lib.prof_reset()
        call()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 32)()
        lib.prof_read(buf)
        nt = -(-q // 64)
        blocks = nt * bt * nc * -(-nh // 8)
        per = {"block": blocks, "head": bt * nc * nh * nt,
               "tile": bt * nc * nh * nt * (nt + 1) // 2}
        total = sum(buf[k] for k in range(len(PHASES)))
        print(f"{name}: {blocks} head-pass blocks, "
              f"{total / blocks:.0f} cycles a block")
        for k, (_, phase, unit) in enumerate(PHASES):
            print(f"  {phase:34s} {buf[k] / per[unit]:8.0f} cycles a {unit:5s}"
                  f" {100 * buf[k] / total:5.1f}%")
        print(f"  chunk launch, slowest block: finish {buf[20]}, dC "
              f"{buf[21]}, dB {buf[22]} cycles")
    return 0


if __name__ == "__main__":
    sys.exit(main())
