// Mamba2 SSD intra-chunk contraction for sm_90a: the quadratic part of
// the chunked scan that every Mamba2 layer's prefill runs.
//
// Replaces the TPU kernel `_ssd_intra_kernel` of
// src/repro/kernels/ssd_scan/kernel.py (Pallas, grid (Bt, nc): one
// program holds a whole chunk in VMEM and unrolls the heads, a (Q, Q)
// float32 score matrix per head). Same contract, all float32: x (Bt, nc,
// Q, nh, hd), dt (Bt, nc, Q, nh), A (nh,), B and C (Bt, nc, Q, N) in;
//   cum[i]       = sum_{j <= i} dt[j] * A           (per head)
//   y[i, p]      = sum_{j <= i} (C_i . B_j) * exp(cum_i - cum_j) * dt_j
//                                * x[j, p]
//   states[p, n] = sum_j x[j, p] * B[j, n] * exp(cum_end - cum_j) * dt_j
// out: y like x, states (Bt, nc, nh, hd, N), cum (Bt, nc, Q, nh). The
// decay is masked before `exp` (j > i gives 0 and never reaches expf):
// the upper triangle of cum_i - cum_j is positive and overflows at long
// chunks (A = -1 at Q 256 reaches exp(+200)). `cum` is accumulated in
// double from float products and rounded once per row, as PyTorch's
// CPU cumsum does, so the kernel's cum equals the plain version's on
// the CPU bit for bit.
//
// Bound on this card: operations. At mamba2-370m's prefill (Bt 4,
// nc 8, Q 256, nh 32, hd 64, N 128) the causal half of C B^T and of the
// score-times-x product and the state product are some 9 GFLOP against
// some 178 MB in and out. The three products run on the tensor cores in
// 3xTF32: each float32 operand is split in registers into big =
// tf32(a) and small = tf32(a - big), and mma.sync m16n8k8 TF32 adds
// small*big + big*small + big*big into float32 accumulators, which keeps
// float32-level error (the dropped small*small term is some 2^-22 of a
// product) at a third of the TF32 rate. Plain TF32 (10 mantissa bits)
// would miss the path's 2e-5 check. The decay, the mask and the weights
// stay on the CUDA cores in float32.
//
// The TPU grid of (Bt, nc) is 32 programs at that shape, too few for 132
// SMs, and a (Q, Q) float32 score matrix per head is 256 KiB, more than
// a block's shared memory; so the grid has two kinds of blocks of 256
// threads (8 warps), one launch:
//  - y blocks, one per (chunk, 64-row tile, group of 8 heads), heaviest
//    row tiles first: C B^T for the tile's 64 rows and the columns up to
//    its diagonal is built once in shared memory by the tensor cores
//    (64-column blocks, 16 state dims a step; each warp a 16 x 32 tile)
//    and reused by the group's 8 heads; per head, 32-column tiles of the
//    masked scores (computed on the CUDA cores) and of x pass through
//    shared memory, and each warp keeps a 16-row x hd/2 tile of y in
//    registers; k-steps wholly above a warp's diagonal are skipped;
//  - state blocks, one per (chunk, head), which also write cum: x and B
//    (32 rows a step) pass through shared memory, the decay weight
//    multiplies x as each fragment is read, and the warps split the
//    hd x N state tile.
// Every tile that comes from device memory is copied with cp.async into
// one of two stages, the next step's copy in flight while this step runs
// (loads issued by each thread into registers went one round trip at a
// time and left the tensor cores waiting), 16 bytes a copy: x, B and C
// must start 16-byte aligned (the C entry returns -5 otherwise; the
// wrapper copies an unaligned input into a fresh buffer).
// Each fragment is read from shared memory straight into registers and
// split there; the leading dimensions are padded so that every fragment
// read is free of bank conflicts (row-major reads: ld = 4 mod 32; k-major
// reads: ld = 8 mod 32). At Q 256 a y block takes 112 KB of dynamic
// shared memory at hd <= 64 (two blocks per SM; __launch_bounds__ holds
// ptxas to 128 registers, where without it ptxas capped them at 80 and
// spilled) and 128 KB at hd 128 (one block, all 255 registers).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTI = 64;          // y rows per block
constexpr int kTJ = 32;          // score / x columns per step (k of y)
constexpr int kTC = 64;          // C B^T columns per block step
constexpr int kTQ = 32;          // rows per state-block step (k of states)
constexpr int kHG = 8;           // heads per y block
constexpr int kMaxQ = 256;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
// state dims a C B^T step takes (k of that product)
__host__ __device__ constexpr int tn_of(int n) { return n < 16 ? n : 16; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
// C B^T in shared memory: its leading dimension, 8 mod 32 (float2 stores
// of the accumulators are then free of bank conflicts)
__host__ __device__ constexpr int cb_ld(int q) { return cdiv(q, 32) * 32 + 8; }

// shared memory of a y block: C B^T, cum and dt of its heads, then either
// the two stages of C and B tiles or the two stages of x tiles and the
// score tile
template <int HD, int N>
__host__ __device__ constexpr int y_smem_floats(int q) {
    return kTI * cb_ld(q) + 2 * kHG * q +
           imax(2 * (kTI + kTC) * (tn_of(N) + 4),
                2 * kTJ * (HD + 8) + kTI * (kTJ + 4));
}

// of a state block: cum and the weights (each padded to whole steps, so
// the tiles start 16-byte aligned), and the two
// stages of x and B tiles
template <int HD, int N>
__host__ __device__ constexpr int s_smem_floats(int q) {
    return 2 * cdiv(q, kTQ) * kTQ + 2 * kTQ * (HD + 8) + 2 * kTQ * (N + 8);
}

// ---------------------------------------------------------------------------
// 3xTF32 on mma.sync m16n8k8
// ---------------------------------------------------------------------------

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: what cvt.rna.tf32.f32 computes for finite x, in two integer
// instructions on the bit pattern, which ran faster than the conversion
__device__ __forceinline__ uint32_t to_tf32(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small, both TF32 (small is the rounding residue, rounded)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
    big = to_tf32(x);
    small = to_tf32(__fsub_rn(x, __uint_as_float(big)));
}

// d += a b: a 16 x 8 (row), b 8 x 8 (col), float32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct FragA { uint32_t big[4], small[4]; };
struct FragB { uint32_t big[2], small[2]; };

// d += a b in 3xTF32: the two small terms first, then big * big
__device__ __forceinline__ void mma_3x(float (&d)[4], const FragA& a,
                                       const FragB& b) {
    mma_tf32(d, a.small, b.big);
    mma_tf32(d, a.big, b.small);
    mma_tf32(d, a.big, b.big);
}

// The fragments' lanes: g = lane / 4 (the row of A, the column of B and
// of the accumulators), t = lane % 4 (the k of A and B).
__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// A (16 x 8) at rows r0.., k0.. of a row-major tile s[row * ld + k]
__device__ __forceinline__ FragA load_a(const float* s, int ld, int r0,
                                        int k0) {
    const int g = lane_g(), t = lane_t();
    const float* p = s + (r0 + g) * ld + k0 + t;
    const float v[4] = {p[0], p[8 * ld], p[4], p[8 * ld + 4]};
    FragA f;
#pragma unroll
    for (int i = 0; i < 4; ++i) split(v[i], f.big[i], f.small[i]);
    return f;
}

// A (16 x 8) from a k-major tile s[k * ld + row] (A is the tile's
// transpose)
__device__ __forceinline__ FragA load_a_t(const float* s, int ld, int r0,
                                          int k0) {
    const int g = lane_g(), t = lane_t();
    const float* p = s + (k0 + t) * ld + r0 + g;
    const float v[4] = {p[0], p[8], p[4 * ld], p[4 * ld + 8]};
    FragA f;
#pragma unroll
    for (int i = 0; i < 4; ++i) split(v[i], f.big[i], f.small[i]);
    return f;
}

// B (8 x 8, k x n) from an n-major tile s[n * ld + k]
__device__ __forceinline__ FragB load_b_nk(const float* s, int ld, int k0,
                                           int n0) {
    const int g = lane_g(), t = lane_t();
    const float* p = s + (n0 + g) * ld + k0 + t;
    FragB f;
    split(p[0], f.big[0], f.small[0]);
    split(p[4], f.big[1], f.small[1]);
    return f;
}

// B (8 x 8, k x n) from a k-major tile s[k * ld + n]
__device__ __forceinline__ FragB load_b_kn(const float* s, int ld, int k0,
                                           int n0) {
    const int g = lane_g(), t = lane_t();
    const float* p = s + (k0 + t) * ld + n0 + g;
    FragB f;
    split(p[0], f.big[0], f.small[0]);
    split(p[4 * ld], f.big[1], f.small[1]);
    return f;
}

// cum of head h over rows 0..len-1 from dt (already in dts), sequential
// in double from float products, rounded once per row
// (the next dt is loaded before this row's store, so no shared-memory
// round trip sits on the chain of double adds)
__device__ __forceinline__ void scan_cum(const float* dts, float a_h,
                                         float* cums, int len) {
    double c = 0.0;
    float next = len > 0 ? dts[0] : 0.0f;
    for (int j = 0; j < len; ++j) {
        const float cur = next;
        if (j + 1 < len) next = dts[j + 1];
        c += static_cast<double>(__fmul_rn(cur, a_h));
        cums[j] = static_cast<float>(c);
    }
}

// A (16 x 8) from a k-major tile s[k * ld + row], each k's values
// scaled by w[k] first (the state product's decay weights on x)
__device__ __forceinline__ FragA load_a_t_scaled(const float* s, int ld,
                                                 int r0, int k0,
                                                 const float* w) {
    const int g = lane_g(), t = lane_t();
    const float* p = s + (k0 + t) * ld + r0 + g;
    const float w0 = w[k0 + t], w1 = w[k0 + t + 4];
    const float v[4] = {__fmul_rn(p[0], w0), __fmul_rn(p[8], w0),
                        __fmul_rn(p[4 * ld], w1), __fmul_rn(p[4 * ld + 8], w1)};
    FragA f;
#pragma unroll
    for (int i = 0; i < 4; ++i) split(v[i], f.big[i], f.small[i]);
    return f;
}

// ---------------------------------------------------------------------------
// tiles into shared memory with cp.async, two stages
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four floats, 16-byte aligned, from device to shared memory,
// asynchronously; `valid` false writes zeros and reads nothing
// (src-size 0)
__device__ __forceinline__ void cp_async_f32x4(float* dst, const float* src,
                                               bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// returns once every group but the newest has landed
__device__ __forceinline__ void cp_async_wait_prev() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// A ROWS x COLS tile into shared memory, dst[r * ld + c] = *src(r, c),
// rows at or past `rows` (>= 1) as zeros: issued, not waited for. Every
// source row and `ld` are 16-byte aligned: four floats a copy.
template <int ROWS, int COLS, typename Src>
__device__ __forceinline__ void copy_tile(float* dst, int ld, int rows,
                                          Src src) {
    static_assert(COLS % 4 == 0, "tile shape");
    constexpr int CV = COLS / 4, NV = ROWS * CV;
#pragma unroll
    for (int k = 0; k < cdiv(NV, kThreads); ++k) {
        const int e = threadIdx.x + k * kThreads;
        if (NV % kThreads == 0 || e < NV) {
            const int r = e / CV, c = (e % CV) * 4;
            const bool ok = r < rows;
            cp_async_f32x4(dst + r * ld + c, src(ok ? r : 0, c), ok);
        }
    }
}

template <int HD, int N>
__device__ void y_block(const float* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const float* __restrict__ Bm,
                        const float* __restrict__ Cm, float* __restrict__ y,
                        float* smem, int Q, int nh, int bc, int it, int g) {
    constexpr int TN = tn_of(N);
    constexpr int NN = N / TN;           // k-steps of C B^T over N
    constexpr int LDN = TN + 4;          // C and B tiles (row-major reads)
    constexpr int LDX = HD + 8;          // x tile (k-major reads)
    constexpr int LDP = kTJ + 4;         // score tile (row-major reads)
    constexpr int NTY = HD / 16;         // y n-tiles a warp (hd/2 columns)
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int rs = warp & 3;             // the warp's 16-row slab
    const int ch = warp >> 2;            // and its column half
    const int lg = lane_g(), lt = lane_t();
    const int LDC = cb_ld(Q);
    float* cbS = smem;                   // kTI x LDC: C_i . B_j
    float* cumS = cbS + kTI * LDC;       // kHG x Q
    float* dtS = cumS + kHG * Q;         // kHG x Q
    float* work = dtS + kHG * Q;
    const int i0 = it * kTI;
    const int jmax = min(i0 + kTI, Q);   // columns the tile's rows reach
    const int h0 = g * kHG;
    const int nhg = min(kHG, nh - h0);
    const long long row0 = static_cast<long long>(bc) * Q;

    // C B^T for rows i0.., columns 0..jmax-1: each warp a 16 x 32 tile of
    // a 64-column block, k over N in steps of TN; step u's tiles are in
    // flight while step u - 1 runs on the tensor cores
    {
        float* Cs = work;                // 2 stages x kTI x LDN
        float* Bs = Cs + 2 * kTI * LDN;  // 2 stages x kTC x LDN
        const int steps = cdiv(jmax, kTC) * NN;
        auto issue = [&](int u) {
            const int j0 = (u / NN) * kTC, n0 = (u % NN) * TN, st = u & 1;
            copy_tile<kTI, TN>(Cs + st * kTI * LDN, LDN, Q - i0,
                               [&](int r, int k) {
                                   return Cm + (row0 + i0 + r) * N + n0 + k;
                               });
            copy_tile<kTC, TN>(Bs + st * kTC * LDN, LDN, jmax - j0,
                               [&](int r, int k) {
                                   return Bm + (row0 + j0 + r) * N + n0 + k;
                               });
            cp_async_commit();
        };
        issue(0);
        for (int e = tid; e < nhg * jmax; e += kThreads) {
            const int j = e / nhg, hh = e % nhg;
            dtS[hh * Q + j] = dt[(row0 + j) * nh + h0 + hh];
        }
        __syncthreads();
        if (tid < nhg)
            scan_cum(dtS + tid * Q, A[h0 + tid], cumS + tid * Q, jmax);
        float acc[4][4];
        for (int u = 0; u < steps; ++u) {
            if (u % NN == 0) {
#pragma unroll
                for (int a = 0; a < 4; ++a)
#pragma unroll
                    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
            }
            if (u + 1 < steps) issue(u + 1);
            else cp_async_commit();
            cp_async_wait_prev();
            __syncthreads();
            const float* C_ = Cs + (u & 1) * kTI * LDN;
            const float* B_ = Bs + (u & 1) * kTC * LDN;
#pragma unroll
            for (int kk = 0; kk < TN; kk += 8) {
                const FragA fa = load_a(C_, LDN, rs * 16, kk);
#pragma unroll
                for (int nt = 0; nt < 4; ++nt)
                    mma_3x(acc[nt], fa,
                           load_b_nk(B_, LDN, kk, ch * 32 + nt * 8));
            }
            if (u % NN == NN - 1) {
                const int j0 = (u / NN) * kTC;
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) {
                    const int col = j0 + ch * 32 + nt * 8 + 2 * lt;
                    if (col < jmax) {
                        float* p = cbS + (rs * 16 + lg) * LDC + col;
                        *reinterpret_cast<float2*>(p) =
                            make_float2(acc[nt][0], acc[nt][1]);
                        *reinterpret_cast<float2*>(p + 8 * LDC) =
                            make_float2(acc[nt][2], acc[nt][3]);
                    }
                }
            }
            __syncthreads();             // this stage read; cb written
        }
    }

    // per head: y = (cb * L * dt) x over 32-column tiles; the next
    // (head, tile)'s x is in flight while this one's scores are computed
    // on the CUDA cores and multiplied on the tensor cores
    float* Xs = work;                    // 2 stages x kTJ x LDX
    float* Ps = Xs + 2 * kTJ * LDX;      // kTI x LDP
    const int njt = cdiv(jmax, kTJ);
    const int steps = nhg * njt;
    const int last_row = i0 + rs * 16 + 15;  // the warp's last row
    auto issue = [&](int u) {
        const int h = h0 + u / njt, j0 = (u % njt) * kTJ;
        copy_tile<kTJ, HD>(Xs + (u & 1) * kTJ * LDX, LDX, Q - j0,
                           [&](int jj, int p) {
                               return x + ((row0 + j0 + jj) * nh + h) * HD + p;
                           });
        cp_async_commit();
    };
    issue(0);
    float acc[NTY][4];
    for (int u = 0; u < steps; ++u) {
        const int hh = u / njt, j0 = (u % njt) * kTJ;
        const int h = h0 + hh;
        const float* cumh = cumS + hh * Q;
        const float* dth = dtS + hh * Q;
        if (j0 == 0) {
#pragma unroll
            for (int a = 0; a < NTY; ++a)
#pragma unroll
                for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
        }
        if (u + 1 < steps) issue(u + 1);
        else cp_async_commit();
        for (int e = tid; e < kTI * kTJ; e += kThreads) {
            const int r = e / kTJ, jj = e % kTJ;
            const int i = i0 + r, j = j0 + jj;
            float v = 0.0f;
            if (j <= i && i < Q)         // masked before exp
                v = __fmul_rn(__fmul_rn(cbS[r * LDC + j],
                                        expf(__fsub_rn(cumh[i], cumh[j]))),
                              dth[j]);
            Ps[r * LDP + jj] = v;
        }
        cp_async_wait_prev();
        __syncthreads();
        const float* X_ = Xs + (u & 1) * kTJ * LDX;
#pragma unroll
        for (int kk = 0; kk < kTJ; kk += 8) {
            if (j0 + kk > last_row) break;   // above the warp's diagonal
            const FragA fa = load_a(Ps, LDP, rs * 16, kk);
#pragma unroll
            for (int nt = 0; nt < NTY; ++nt)
                mma_3x(acc[nt], fa,
                       load_b_kn(X_, LDX, kk, ch * (HD / 2) + nt * 8));
        }
        if (j0 + kTJ >= jmax) {          // the head's last tile
#pragma unroll
            for (int nt = 0; nt < NTY; ++nt) {
                const int col = ch * (HD / 2) + nt * 8 + 2 * lt;
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int i = i0 + rs * 16 + lg + 8 * half;
                    if (i < Q)
                        *reinterpret_cast<float2*>(
                            y + ((row0 + i) * nh + h) * HD + col) =
                            make_float2(acc[nt][2 * half],
                                        acc[nt][2 * half + 1]);
                }
            }
        }
        __syncthreads();                 // this stage and Ps read
    }
}

template <int HD, int N>
__device__ void state_block(const float* __restrict__ x,
                            const float* __restrict__ dt,
                            const float* __restrict__ A,
                            const float* __restrict__ Bm,
                            float* __restrict__ states,
                            float* __restrict__ cum, float* smem, int Q,
                            int nh, int bc, int h) {
    constexpr int LDX = HD + 8;              // k-major reads
    constexpr int LDB = N + 8;
    constexpr int MT = HD / 16;              // m-tiles of the hd x N state
    constexpr int NT = N / 8;                // n-tiles
    constexpr int WN = kWarps / MT;          // warps over the n-tiles
    constexpr int NPW = NT / WN > 0 ? NT / WN : 1;   // n-tiles a warp
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int mt = warp % MT, n_first = (warp / MT) * NPW;
    const bool active = n_first < NT;
    const int lg = lane_g(), lt = lane_t();
    const int steps = cdiv(Q, kTQ);
    float* cumS = smem;                      // Q (of steps * kTQ)
    float* wS = cumS + steps * kTQ;          // steps * kTQ: dt, then weight
    float* Xs = wS + steps * kTQ;            // 2 stages x kTQ x LDX
    float* Bs = Xs + 2 * kTQ * LDX;          // 2 stages x kTQ x LDB
    const long long row0 = static_cast<long long>(bc) * Q;

    // x and B go through unweighted (cp.async); the weight multiplies x
    // as each A fragment is read, x * w as the plain version has it
    auto issue = [&](int u) {
        const int j0 = u * kTQ, st = u & 1;
        copy_tile<kTQ, HD>(Xs + st * kTQ * LDX, LDX, Q - j0,
                           [&](int jj, int p) {
                               return x + ((row0 + j0 + jj) * nh + h) * HD + p;
                           });
        copy_tile<kTQ, N>(Bs + st * kTQ * LDB, LDB, Q - j0,
                          [&](int jj, int nn) {
                              return Bm + (row0 + j0 + jj) * N + nn;
                          });
        cp_async_commit();
    };
    issue(0);
    for (int j = tid; j < steps * kTQ; j += kThreads)
        wS[j] = j < Q ? dt[(row0 + j) * nh + h] : 0.0f;
    __syncthreads();
    if (tid == 0) scan_cum(wS, A[h], cumS, Q);
    __syncthreads();
    const float cend = cumS[Q - 1];
    for (int j = tid; j < Q; j += kThreads) {
        cum[(row0 + j) * nh + h] = cumS[j];
        wS[j] = __fmul_rn(expf(__fsub_rn(cend, cumS[j])), wS[j]);
    }

    float acc[NPW][4];
#pragma unroll
    for (int a = 0; a < NPW; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
    for (int u = 0; u < steps; ++u) {
        if (u + 1 < steps) issue(u + 1);
        else cp_async_commit();
        cp_async_wait_prev();
        __syncthreads();                     // stage u and the weights ready
        if (active) {
            const float* X_ = Xs + (u & 1) * kTQ * LDX;
            const float* B_ = Bs + (u & 1) * kTQ * LDB;
            const float* w = wS + u * kTQ;
#pragma unroll
            for (int kk = 0; kk < kTQ; kk += 8) {
                const FragA fa = load_a_t_scaled(X_, LDX, mt * 16, kk, w);
#pragma unroll
                for (int r = 0; r < NPW; ++r)
                    mma_3x(acc[r], fa,
                           load_b_kn(B_, LDB, kk, (n_first + r) * 8));
            }
        }
        __syncthreads();                     // stage u read
    }
    if (active) {
        const long long base = (static_cast<long long>(bc) * nh + h) * HD;
#pragma unroll
        for (int r = 0; r < NPW; ++r) {
            const int n = (n_first + r) * 8 + 2 * lt;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int p = mt * 16 + lg + 8 * half;
                *reinterpret_cast<float2*>(states + (base + p) * N + n) =
                    make_float2(acc[r][2 * half], acc[r][2 * half + 1]);
            }
        }
    }
}

// blocks an SM holds: two at hd <= 64 (ptxas held to 128 registers), one
// at hd 128, whose y block takes 128 KB of shared memory anyway
template <int HD>
constexpr int min_blocks() { return HD <= 64 ? 2 : 1; }

template <int HD, int N>
__global__ void __launch_bounds__(kThreads, min_blocks<HD>())
ssd_intra_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ states, float* __restrict__ cum, int BC,
                 int Q, int nh) {
    extern __shared__ __align__(16) float smem[];
    const int nt = cdiv(Q, kTI), ng = cdiv(nh, kHG);
    const long long per_tile = static_cast<long long>(BC) * ng;
    const long long n_y = per_tile * nt;
    const long long blk = blockIdx.x;
    if (blk < n_y) {
        const int it = nt - 1 - static_cast<int>(blk / per_tile);
        const int rem = static_cast<int>(blk % per_tile);
        y_block<HD, N>(x, dt, A, Bm, Cm, y, smem, Q, nh, rem / ng, it,
                            rem % ng);
    } else {
        const long long s = blk - n_y;
        state_block<HD, N>(x, dt, A, Bm, states, cum, smem, Q, nh,
                           static_cast<int>(s / nh),
                           static_cast<int>(s % nh));
    }
}

template <int HD, int N>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, void* states, void* cum, int BC, int Q,
           int nh, cudaStream_t st) {
    static_assert(HD % 16 == 0 && HD / 16 <= kWarps && N % 16 == 0,
                  "tile shape");
    auto kernel = ssd_intra_kernel<HD, N>;
    constexpr int max_floats = imax(y_smem_floats<HD, N>(kMaxQ),
                                    s_smem_floats<HD, N>(kMaxQ));
    static bool attr_set = false;            // once per instantiation
    if (!attr_set) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(sizeof(float) * max_floats));
        if (e != cudaSuccess) return static_cast<int>(e);
        attr_set = true;
    }
    const int yf = y_smem_floats<HD, N>(Q), sf = s_smem_floats<HD, N>(Q);
    const size_t smem = sizeof(float) * static_cast<size_t>(imax(yf, sf));
    const long long blocks =
        static_cast<long long>(BC) * (cdiv(Q, kTI) * cdiv(nh, kHG) + nh);
    if (blocks > 0x7fffffffLL) return -4;
    kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const float*>(B),
        static_cast<const float*>(C), static_cast<float*>(y),
        static_cast<float*>(states), static_cast<float*>(cum), BC, Q, nh);
    return static_cast<int>(cudaGetLastError());
}

template <int HD>
int dispatch_n(int n, const void* x, const void* dt, const void* A,
               const void* B, const void* C, void* y, void* states, void* cum,
               int BC, int Q, int nh, cudaStream_t st) {
    switch (n) {
        case 16: return launch<HD, 16>(x, dt, A, B, C, y, states, cum, BC, Q, nh, st);
        case 32: return launch<HD, 32>(x, dt, A, B, C, y, states, cum, BC, Q, nh, st);
        case 64: return launch<HD, 64>(x, dt, A, B, C, y, states, cum, BC, Q, nh, st);
        case 128: return launch<HD, 128>(x, dt, A, B, C, y, states, cum, BC, Q, nh, st);
        default: return -2;
    }
}

}  // namespace

extern "C" int ssd_intra(const void* x, const void* dt, const void* A,
                         const void* B, const void* C, void* y, void* states,
                         void* cum, int BC, int Q, int nh, int hd, int n,
                         void* stream) {
    if (BC < 1 || Q < 1 || Q > kMaxQ || nh < 1) return -3;
    // x, B and C rows start 16-byte aligned when their bases do (hd and N
    // are multiples of 4): the tiles go four floats a copy
    if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(B) |
          reinterpret_cast<uintptr_t>(C)) & 15) != 0)
        return -5;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (hd) {
        case 16: return dispatch_n<16>(n, x, dt, A, B, C, y, states, cum, BC, Q, nh, st);
        case 32: return dispatch_n<32>(n, x, dt, A, B, C, y, states, cum, BC, Q, nh, st);
        case 64: return dispatch_n<64>(n, x, dt, A, B, C, y, states, cum, BC, Q, nh, st);
        case 128: return dispatch_n<128>(n, x, dt, A, B, C, y, states, cum, BC, Q, nh, st);
        default: return -2;
    }
}
