// Backward of the Mamba2 SSD intra-chunk contraction for sm_90a: the
// gradient that training takes through `ssd_intra` (csrc/ssd_intra.cu).
//
// Replaces no TPU kernel: the reference trains Mamba2 by `jax.grad`
// through its jnp `ssd_chunked` (src/repro/models/mamba2.py:67), whose
// intra-chunk part is what the Pallas `_ssd_intra_kernel` computes in the
// forward. Same contract as the plain version, `ref.intra_chunk_bwd_ref`
// (autograd through `ref.intra_chunk_ref`), all float32: the forward's
// inputs x (Bt, nc, Q, nh, hd), dt (Bt, nc, Q, nh), A (nh,), B and C
// (Bt, nc, Q, N), and the cotangents dy (like x), dstates (Bt, nc, nh,
// hd, N) and dcum (like dt) in; dx, ddt, dA, dB, dC out, each like its
// input. Per (chunk, head), with the decay masked before `exp`:
//   e_ij = exp(cum_i - cum_j) for i >= j, exactly 0 above the diagonal
//   cb = C B^T,  S_ij = cb_ij e_ij dt_j,  w_j = exp(cum_end - cum_j) dt_j
//   dS = dy x^T,  dx = S^T dy + w * (B dst^T),  P = dS * S
//   dcb = sum over heads of dS e dt_j;  dC = dcb B,  dB = dcb^T C
//         + sum over heads of (w * x) dst
//   ddt_j = sum_i dS_ij cb_ij e_ij + dw_j exp(cum_end - cum_j) + da_j A
//   dcum_i = dcum_in_i + sum_j P_ij - sum_k P_ki - d_i + [i = end] sum d
//     (dw = rowsum(x * (B dst^T)), d_j = dw_j dt_j exp(cum_end - cum_j))
//   da = the reverse cumulative sum of dcum over the rows, in double, as
//     the plain version's float64 cumsum differentiates; dA = sum da dt.
// Masked entries contribute exactly 0 (never 0 * inf): e is 0 there
// before any product. `cum` is recomputed here as the forward computes it
// (double from the float products dt * A, rounded once a row), so the
// Function saves only its inputs.
//
// Bound on this card: operations. At mamba2-370m's training shape (Bt 2,
// nc 8, Q 256, nh 32, hd 64, N 128) the causal half of dS, S^T dy, dcb B
// and dcb^T C, with C B^T and the full B dst^T and (w x) dst, are some
// 9 GFLOP against some 128 MB in and out. The products run on the tensor
// cores in 3xTF32 as in ssd_intra.cu (mma.sync m16n8k8 TF32, each float32
// operand split in registers into big and small; plain TF32 would miss
// the float32-level check); the decay, the mask and every sum stay in
// float32 on the CUDA cores.
//
// Five launches, each a pass over the chunk's tiles of 64 rows, 256
// threads (8 warps) a block; no atomics, so two calls give the same bits
// (the cross-head and cross-chunk sums are partials added in a fixed
// order):
//  1. cum per (chunk, head) into scratch;
//  2. per (chunk, 64 x 64 tile on or below the diagonal): C B^T (kept for
//     pass 3) and dcb summed over every head in registers, dy and x tiles
//     of the next head in flight (cp.async, two stages) while this one's
//     dS runs;
//  3. per (chunk, group of 4 heads, 64-column tile j), heaviest first:
//     per head, B dst^T gives dx's state term and dw, (w x) dst adds to
//     the group's dB partial in registers; then for each row tile i >= j
//     dS in registers, S, P and their column and row sums on the CUDA
//     cores, S through shared memory into dx += S^T dy; dx and the
//     column sums written whole, the row sums as partials a column tile;
//  4. per (chunk, 64-row tile): dC = dcb B and dB = dcb^T C plus the
//     groups' partials;
//  5. per head: dcum assembled, its reverse cumsum in double (a warp a
//     chunk), ddt completed, dA summed over chunks in a fixed order.
// Tiles come from device memory by 16-byte cp.async copies, so x, dy, B,
// C and dstates must start 16-byte aligned (the C entry returns -5
// otherwise; the wrapper copies an unaligned input into a fresh buffer).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;           // tile rows and columns
constexpr int kHG = 4;           // heads a block of pass 3
constexpr int kMaxQ = 256;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// ---------------------------------------------------------------------------
// 3xTF32 on mma.sync m16n8k8 (as in ssd_intra.cu)
// ---------------------------------------------------------------------------

// x rounded to TF32, to nearest with ties away from zero (cvt.rna)
__device__ __forceinline__ uint32_t to_tf32(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
    big = to_tf32(x);
    small = to_tf32(__fsub_rn(x, __uint_as_float(big)));
}

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

__device__ __forceinline__ void mma_3x(float (&d)[4], const FragA& a,
                                       const FragB& b) {
    mma_tf32(d, a.small, b.big);
    mma_tf32(d, a.big, b.small);
    mma_tf32(d, a.big, b.big);
}

// g = lane / 4: the row of A, the column of B and of the accumulators;
// t = lane % 4: the k of A and B. Accumulator d[2 * half + e] sits at
// row g + 8 * half, column 2 t + e.
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

// the same, each row scaled by w[row] first (x * w as the plain version
// forms it before its product)
__device__ __forceinline__ FragA load_a_scaled(const float* s, int ld,
                                               int r0, int k0,
                                               const float* w) {
    const int g = lane_g(), t = lane_t();
    const float* p = s + (r0 + g) * ld + k0 + t;
    const float w0 = w[r0 + g], w1 = w[r0 + g + 8];
    const float v[4] = {__fmul_rn(p[0], w0), __fmul_rn(p[8 * ld], w1),
                        __fmul_rn(p[4], w0), __fmul_rn(p[8 * ld + 4], w1)};
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

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
    for (int a = 0; a < NT; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
}

// ---------------------------------------------------------------------------
// tiles into shared memory with cp.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_f32x4(float* dst, const float* src,
                                               bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// once every group but the newest has landed
__device__ __forceinline__ void cp_async_wait_prev() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A ROWS x COLS tile into shared memory, dst[r * ld + c] = *src(r, c),
// rows at or past `rows` as zeros: issued, not waited for
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

// ---------------------------------------------------------------------------
// the scratch: one float32 buffer, its parts by (BC, Q, nh, N); Qp is Q
// padded to whole tiles
// ---------------------------------------------------------------------------

struct Work {
    float* cum;      // (BC, nh, Qp): cum per (chunk, head)
    float* cb;       // (BC, Qp, Qp): C B^T, tiles on and below the diagonal
    float* dcb;      // (BC, Qp, Qp): dcb, the same tiles
    float* dbs;      // (BC, ng, Qp, N): sum over a group's heads of (w x) dst
    float* rowp;     // (BC, nh, nt, Qp): row sums of P over a column tile
    float* col;      // (BC, nh, Qp): -(column sums of P) - d
    float* dend;     // (BC, nh, nt): sum of d over a column tile
};

// the scratch's floats; with `w`, its parts' pointers into `base`
long long work_floats(int BC, int Q, int nh, int n, Work* w, float* base) {
    const long long nt = cdiv(Q, kT), qp = nt * kT, ng = cdiv(nh, kHG);
    const long long sizes[7] = {BC * nh * qp, BC * qp * qp, BC * qp * qp,
                                BC * ng * qp * n, BC * nh * nt * qp,
                                BC * nh * qp, BC * nh * nt};
    float** parts[7] = {nullptr, nullptr, nullptr, nullptr, nullptr,
                        nullptr, nullptr};
    if (w != nullptr) {
        parts[0] = &w->cum; parts[1] = &w->cb; parts[2] = &w->dcb;
        parts[3] = &w->dbs; parts[4] = &w->rowp; parts[5] = &w->col;
        parts[6] = &w->dend;
    }
    long long at = 0;
    for (int k = 0; k < 7; ++k) {
        if (w != nullptr) *parts[k] = base + at;
        at += (sizes[k] + 3) / 4 * 4;        // each part 16-byte aligned
    }
    return at;
}

// ---------------------------------------------------------------------------
// pass 1: cum, per (chunk, group of 32 heads): dt staged in shared memory,
// then one thread a head sums sequentially in double from the float
// products, rounded once a row (the forward's scan_cum), in place
// ---------------------------------------------------------------------------

constexpr int kCumHeads = 32;

__global__ void __launch_bounds__(kThreads)
ssd_intra_bwd_cum(const float* __restrict__ dt, const float* __restrict__ A,
                  Work wk, int BC, int Q, int nh) {
    __shared__ float s[kMaxQ][kCumHeads + 1];
    const int per = cdiv(nh, kCumHeads);
    const int bc = blockIdx.x / per;
    const int h0 = (blockIdx.x % per) * kCumHeads;
    const int hn = min(kCumHeads, nh - h0);
    const int qp = cdiv(Q, kT) * kT;
    const float* d = dt + static_cast<long long>(bc) * Q * nh + h0;
    for (int e = threadIdx.x; e < Q * kCumHeads; e += kThreads) {
        const int i = e / kCumHeads, hh = e % kCumHeads;
        if (hh < hn) s[i][hh] = d[static_cast<long long>(i) * nh + hh];
    }
    __syncthreads();
    if (threadIdx.x < hn) {
        const int hh = threadIdx.x;
        const float a_h = A[h0 + hh];
        double c = 0.0;
        float next = s[0][hh];
        for (int i = 0; i < Q; ++i) {
            const float cur = next;
            if (i + 1 < Q) next = s[i + 1][hh];
            c += static_cast<double>(__fmul_rn(cur, a_h));
            s[i][hh] = static_cast<float>(c);
        }
    }
    __syncthreads();
    for (int hh = 0; hh < hn; ++hh) {
        float* out = wk.cum + (static_cast<long long>(bc) * nh + h0 + hh) * qp;
        for (int i = threadIdx.x; i < qp; i += kThreads)
            out[i] = i < Q ? s[i][hh] : 0.0f;
    }
}

// ---------------------------------------------------------------------------
// pass 2: per (chunk, tile (it, jt) with jt <= it): cb = C B^T and dcb =
// sum over heads of (dy x^T) * dt_j * e
// ---------------------------------------------------------------------------

template <int HD, int N>
__host__ __device__ constexpr int p2_smem_floats() {
    return imax(2 * kT * (N + 4),
                2 * 2 * kT * (HD + 4) + 2 * 3 * kT);
}

template <int HD, int N>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 2 : 1)
ssd_intra_bwd_dcb(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ Bm, const float* __restrict__ Cm,
                  const float* __restrict__ dy, Work wk, int Q, int nh) {
    extern __shared__ __align__(16) float smem[];
    constexpr int LDN = N + 4, LDH = HD + 4;
    const int nt = cdiv(Q, kT), qp = nt * kT;
    const int npairs = nt * (nt + 1) / 2;
    const int bc = blockIdx.x / npairs;
    int pr = blockIdx.x % npairs, it = 0;
    while (pr > it) { pr -= it + 1; ++it; }
    const int jt = pr;
    const int i0 = it * kT, j0 = jt * kT;
    const int tid = threadIdx.x, warp = tid >> 5;
    const int rs = warp & 3, ch = warp >> 2;
    const int lg = lane_g(), lt = lane_t();
    const long long row0 = static_cast<long long>(bc) * Q;

    // cb for the tile: each warp a 16 x 32 block
    {
        float* Cs = smem;
        float* Bs = Cs + kT * LDN;
        copy_tile<kT, N>(Cs, LDN, Q - i0, [&](int r, int c) {
            return Cm + (row0 + i0 + r) * N + c; });
        copy_tile<kT, N>(Bs, LDN, Q - j0, [&](int r, int c) {
            return Bm + (row0 + j0 + r) * N + c; });
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        float acc[4][4];
        zero(acc);
#pragma unroll 4
        for (int kk = 0; kk < N; kk += 8) {
            const FragA fa = load_a(Cs, LDN, rs * 16, kk);
#pragma unroll
            for (int n8 = 0; n8 < 4; ++n8)
                mma_3x(acc[n8], fa, load_b_nk(Bs, LDN, kk, ch * 32 + n8 * 8));
        }
        float* out = wk.cb + static_cast<long long>(bc) * qp * qp;
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8) {
            const int j = j0 + ch * 32 + n8 * 8 + 2 * lt;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int i = i0 + rs * 16 + lg + 8 * half;
                *reinterpret_cast<float2*>(out + static_cast<long long>(i) *
                                           qp + j) =
                    make_float2(acc[n8][2 * half], acc[n8][2 * half + 1]);
            }
        }
        __syncthreads();                 // Cs and Bs read
    }

    // dcb: per head, dS = dy_i x_j^T, then dS * dt_j * e into the sum;
    // the next head's tiles in flight while this one runs
    float* stage = smem;                 // 2 x (dy tile, x tile)
    float* vec = smem + 2 * 2 * kT * LDH;    // 2 x (cum_i, cum_j, dt_j)
    auto issue = [&](int h) {
        const int st = h & 1;
        float* dys = stage + st * 2 * kT * LDH;
        float* xs = dys + kT * LDH;
        copy_tile<kT, HD>(dys, LDH, Q - i0, [&](int r, int c) {
            return dy + ((row0 + i0 + r) * nh + h) * HD + c; });
        copy_tile<kT, HD>(xs, LDH, Q - j0, [&](int r, int c) {
            return x + ((row0 + j0 + r) * nh + h) * HD + c; });
        cp_async_commit();
        if (tid < kT) {
            float* v = vec + st * 3 * kT;
            const float* cum = wk.cum + (static_cast<long long>(bc) * nh + h) *
                                            qp;
            v[tid] = cum[i0 + tid];
            v[kT + tid] = cum[j0 + tid];
            v[2 * kT + tid] = j0 + tid < Q ? dt[(row0 + j0 + tid) * nh + h]
                                           : 0.0f;
        }
    };
    float dcb[4][4];
    zero(dcb);
    issue(0);
    for (int h = 0; h < nh; ++h) {
        if (h + 1 < nh) issue(h + 1);
        else cp_async_commit();
        cp_async_wait_prev();
        __syncthreads();
        const int st = h & 1;
        const float* dys = stage + st * 2 * kT * LDH;
        const float* xs = dys + kT * LDH;
        const float* v = vec + st * 3 * kT;
        float acc[4][4];
        zero(acc);
#pragma unroll 4
        for (int kk = 0; kk < HD; kk += 8) {
            const FragA fa = load_a(dys, LDH, rs * 16, kk);
#pragma unroll
            for (int n8 = 0; n8 < 4; ++n8)
                mma_3x(acc[n8], fa, load_b_nk(xs, LDH, kk, ch * 32 + n8 * 8));
        }
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int li = rs * 16 + lg + 8 * (e >> 1);
                const int lj = ch * 32 + n8 * 8 + 2 * lt + (e & 1);
                const int i = i0 + li, j = j0 + lj;
                if (i < Q && j <= i) {   // masked before exp
                    const float el = expf(__fsub_rn(v[li], v[kT + lj]));
                    dcb[n8][e] = __fadd_rn(
                        dcb[n8][e],
                        __fmul_rn(__fmul_rn(acc[n8][e], v[2 * kT + lj]), el));
                }
            }
        __syncthreads();                 // this stage read
    }
    float* out = wk.dcb + static_cast<long long>(bc) * qp * qp;
#pragma unroll
    for (int n8 = 0; n8 < 4; ++n8) {
        const int j = j0 + ch * 32 + n8 * 8 + 2 * lt;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int i = i0 + rs * 16 + lg + 8 * half;
            *reinterpret_cast<float2*>(out + static_cast<long long>(i) * qp +
                                       j) =
                make_float2(dcb[n8][2 * half], dcb[n8][2 * half + 1]);
        }
    }
}

// ---------------------------------------------------------------------------
// pass 3: per (chunk, group of kHG heads, column tile jt)
// ---------------------------------------------------------------------------

template <int HD, int N>
struct P3 {
    static constexpr int LDN = N + 4, LDH = HD + 4, LDS = kT + 8;
    // B_j tile, x_j tile, then dst (per head) or (two dy stages and S),
    // then the vectors
    static constexpr int bs = 0;
    static constexpr int xs = bs + kT * LDN;
    static constexpr int un = xs + kT * LDH;
    static constexpr int ds = un;
    static constexpr int dys = un;
    static constexpr int ss = dys + 2 * kT * LDH;
    static constexpr int vec = un + imax(HD * LDN, 2 * kT * LDH + kT * LDS);
    // cum and dt of the head (kMaxQ each), w and exp(cum_end - cum) of
    // the tile's rows, partial sums: 4 row slabs x 64 columns x 2, 2
    // column halves x 64 rows, dw's 2 x 64
    static constexpr int floats = vec + 2 * kMaxQ + 2 * kT + 8 * kT +
                                  2 * kT + 2 * kT;
};

// one block an SM: capped at 128 registers for two, ptxas spilled at every
// hd <= 64 (184 bytes at hd 64, N 128), and the two ran no faster
template <int HD, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_intra_bwd_heads(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ Bm,
                    const float* __restrict__ dy,
                    const float* __restrict__ dst, float* __restrict__ dx,
                    float* __restrict__ ddt, Work wk, int BC, int Q, int nh) {
    extern __shared__ __align__(16) float smem[];
    using L = P3<HD, N>;
    constexpr int LDN = L::LDN, LDH = L::LDH, LDS = L::LDS;
    constexpr int NTX = HD / 16;         // dx n-tiles a warp (hd / 2 wide)
    constexpr int NTB = N / 16;          // dB n-tiles a warp (N / 2 wide)
    const int nt = cdiv(Q, kT), qp = nt * kT, ng = cdiv(nh, kHG);
    const long long per = static_cast<long long>(BC) * ng;
    const int jt = static_cast<int>(blockIdx.x / per);     // heaviest first
    const int rem = static_cast<int>(blockIdx.x % per);
    const int bc = rem / ng, g = rem % ng;
    const int j0 = jt * kT;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int rs = warp & 3, ch = warp >> 2;
    const int lg = lane_g(), lt = lane_t();
    const long long row0 = static_cast<long long>(bc) * Q;
    float* Bs = smem + L::bs;
    float* Xs = smem + L::xs;
    float* Ds = smem + L::ds;
    float* DYs = smem + L::dys;
    float* Ss = smem + L::ss;
    float* cumS = smem + L::vec;
    float* dtS = cumS + kMaxQ;
    float* wS = dtS + kMaxQ;             // w of the tile's rows
    float* eS = wS + kT;                 // exp(cum_end - cum) of them
    float* colred = eS + kT;             // [2][4][64]: P, dS cb e
    float* rowred = colred + 8 * kT;     // [2][64]
    float* dwred = rowred + 2 * kT;      // [2][64]
    const float* cbt = wk.cb + static_cast<long long>(bc) * qp * qp;

    copy_tile<kT, N>(Bs, LDN, Q - j0, [&](int r, int c) {
        return Bm + (row0 + j0 + r) * N + c; });
    cp_async_commit();

    float dbs[NTB][4];
    zero(dbs);
    const int h_end = min(nh, (g + 1) * kHG);
    for (int h = g * kHG; h < h_end; ++h) {
        // x_j and dst of the head, its cum and dt
        copy_tile<kT, HD>(Xs, LDH, Q - j0, [&](int r, int c) {
            return x + ((row0 + j0 + r) * nh + h) * HD + c; });
        copy_tile<HD, N>(Ds, LDN, HD, [&](int r, int c) {
            return dst + ((static_cast<long long>(bc) * nh + h) * HD + r) * N +
                   c; });
        cp_async_commit();
        const float* cum = wk.cum + (static_cast<long long>(bc) * nh + h) * qp;
        for (int i = tid; i < qp; i += kThreads) {
            cumS[i] = cum[i];
            dtS[i] = i < Q ? dt[(row0 + i) * nh + h] : 0.0f;
        }
        __syncthreads();
        const float cend = cumS[Q - 1];
        if (tid < kT) {
            const float e = j0 + tid < Q
                                ? expf(__fsub_rn(cend, cumS[j0 + tid])) : 0.0f;
            eS[tid] = e;
            wS[tid] = __fmul_rn(e, dtS[j0 + tid]);
        }
        cp_async_wait_all();
        __syncthreads();

        // V = B_j dst^T: dx's state term and dw = rowsum(x * V)
        float dxa[NTX][4];
        zero(dxa);
#pragma unroll 4
        for (int kk = 0; kk < N; kk += 8) {
            const FragA fa = load_a(Bs, LDN, rs * 16, kk);
#pragma unroll
            for (int n8 = 0; n8 < NTX; ++n8)
                mma_3x(dxa[n8], fa,
                       load_b_nk(Ds, LDN, kk, ch * (HD / 2) + n8 * 8));
        }
        float dwp[2] = {0.0f, 0.0f};
#pragma unroll
        for (int n8 = 0; n8 < NTX; ++n8)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = rs * 16 + lg + 8 * (e >> 1);
                const int c = ch * (HD / 2) + n8 * 8 + 2 * lt + (e & 1);
                dwp[e >> 1] = __fadd_rn(dwp[e >> 1],
                                        __fmul_rn(dxa[n8][e], Xs[r * LDH + c]));
            }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            dwp[half] += __shfl_xor_sync(0xffffffffu, dwp[half], 1);
            dwp[half] += __shfl_xor_sync(0xffffffffu, dwp[half], 2);
            if (lt == 0) dwred[ch * kT + rs * 16 + lg + 8 * half] = dwp[half];
        }
#pragma unroll
        for (int n8 = 0; n8 < NTX; ++n8)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                dxa[n8][e] = __fmul_rn(dxa[n8][e],
                                       wS[rs * 16 + lg + 8 * (e >> 1)]);
        // the group's dB partial += (w x_j) dst
#pragma unroll 4
        for (int kk = 0; kk < HD; kk += 8) {
            const FragA fa = load_a_scaled(Xs, LDH, rs * 16, kk, wS);
#pragma unroll
            for (int n8 = 0; n8 < NTB; ++n8)
                mma_3x(dbs[n8], fa,
                       load_b_kn(Ds, LDN, kk, ch * (N / 2) + n8 * 8));
        }
        __syncthreads();                 // Ds read: the union is free

        // row tiles i >= j: dS, S, P; dx += S^T dy
        float colp[4][2], cold[4][2];
#pragma unroll
        for (int a = 0; a < 4; ++a)
            colp[a][0] = colp[a][1] = cold[a][0] = cold[a][1] = 0.0f;
        auto issue = [&](int it) {
            copy_tile<kT, HD>(DYs + (it & 1) * kT * LDH, LDH, Q - it * kT,
                              [&](int r, int c) {
                                  return dy + ((row0 + it * kT + r) * nh + h) *
                                                  HD + c; });
            cp_async_commit();
        };
        issue(jt);
        for (int it = jt; it < nt; ++it) {
            const int i0 = it * kT;
            if (it + 1 < nt) issue(it + 1);
            else cp_async_commit();
            // this thread's C B^T entries, read while the tile lands
            float cbv[4][4];
#pragma unroll
            for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const float2 v = *reinterpret_cast<const float2*>(
                        cbt + static_cast<long long>(i0 + rs * 16 + lg +
                                                     8 * half) * qp +
                        j0 + ch * 32 + n8 * 8 + 2 * lt);
                    cbv[n8][2 * half] = v.x;
                    cbv[n8][2 * half + 1] = v.y;
                }
            cp_async_wait_prev();
            __syncthreads();
            const float* DY = DYs + (it & 1) * kT * LDH;
            float acc[4][4];
            zero(acc);
#pragma unroll 4
            for (int kk = 0; kk < HD; kk += 8) {
                const FragA fa = load_a(DY, LDH, rs * 16, kk);
#pragma unroll
                for (int n8 = 0; n8 < 4; ++n8)
                    mma_3x(acc[n8], fa, load_b_nk(Xs, LDH, kk, ch * 32 + n8 * 8));
            }
            float rowp[2] = {0.0f, 0.0f};
#pragma unroll
            for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int li = rs * 16 + lg + 8 * (e >> 1);
                    const int lj = ch * 32 + n8 * 8 + 2 * lt + (e & 1);
                    const int i = i0 + li, j = j0 + lj;
                    float s = 0.0f;
                    if (i < Q && j <= i) {   // masked before exp
                        const float el = expf(__fsub_rn(cumS[i], cumS[j]));
                        const float dtj = dtS[j];
                        const float ds_ = acc[n8][e];
                        const float cbl = __fmul_rn(cbv[n8][e], el);
                        s = __fmul_rn(cbl, dtj);
                        const float p = __fmul_rn(
                            __fmul_rn(__fmul_rn(ds_, dtj), cbv[n8][e]), el);
                        colp[n8][e & 1] = __fadd_rn(colp[n8][e & 1], p);
                        cold[n8][e & 1] = __fadd_rn(cold[n8][e & 1],
                                                    __fmul_rn(ds_, cbl));
                        rowp[e >> 1] = __fadd_rn(rowp[e >> 1], p);
                    }
                    Ss[li * LDS + lj] = s;
                }
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                rowp[half] += __shfl_xor_sync(0xffffffffu, rowp[half], 1);
                rowp[half] += __shfl_xor_sync(0xffffffffu, rowp[half], 2);
                if (lt == 0) rowred[ch * kT + rs * 16 + lg + 8 * half] =
                                 rowp[half];
            }
            __syncthreads();             // S and the row partials written
            if (tid < kT && i0 + tid < Q)
                wk.rowp[((static_cast<long long>(bc) * nh + h) * nt + jt) * qp +
                        i0 + tid] = __fadd_rn(rowred[tid], rowred[kT + tid]);
#pragma unroll
            for (int kk = 0; kk < kT; kk += 8) {
                // S_ij = 0 for i < j: skip k-steps above the warp's rows
                if (i0 + kk + 7 < j0 + rs * 16 || i0 + kk >= Q) continue;
                const FragA fa = load_a_t(Ss, LDS, rs * 16, kk);
#pragma unroll
                for (int n8 = 0; n8 < NTX; ++n8)
                    mma_3x(dxa[n8], fa,
                           load_b_kn(DY, LDH, kk, ch * (HD / 2) + n8 * 8));
            }
            __syncthreads();             // this dy stage and S read
        }

        // dx of the head's column tile
#pragma unroll
        for (int n8 = 0; n8 < NTX; ++n8) {
            const int c = ch * (HD / 2) + n8 * 8 + 2 * lt;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int j = j0 + rs * 16 + lg + 8 * half;
                if (j < Q)
                    *reinterpret_cast<float2*>(dx + ((row0 + j) * nh + h) * HD +
                                               c) =
                        make_float2(dxa[n8][2 * half], dxa[n8][2 * half + 1]);
            }
        }
        // column sums: over the warp's 16 rows, then the 4 row slabs in
        // order
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                float p = colp[n8][e], d = cold[n8][e];
#pragma unroll
                for (int m = 4; m < 32; m <<= 1) {
                    p += __shfl_xor_sync(0xffffffffu, p, m);
                    d += __shfl_xor_sync(0xffffffffu, d, m);
                }
                if (lg == 0) {
                    const int c = ch * 32 + n8 * 8 + 2 * lt + e;
                    colred[rs * kT + c] = p;
                    colred[4 * kT + rs * kT + c] = d;
                }
            }
        __syncthreads();
        if (warp == 0) {
            // the tile's 64 columns, two a lane: d_j, then the tile's sum
            // of d in a fixed order
            float dsum = 0.0f;
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                const int c = lane + 32 * k;
                const int j = j0 + c;
                float p = colred[c], d = colred[4 * kT + c];
#pragma unroll
                for (int r = 1; r < 4; ++r) {
                    p = __fadd_rn(p, colred[r * kT + c]);
                    d = __fadd_rn(d, colred[4 * kT + r * kT + c]);
                }
                const float dw = __fadd_rn(dwred[c], dwred[kT + c]);
                // d_j = (dw_j dt_j) exp(cum_end - cum_j)
                const float dj = j < Q ? __fmul_rn(__fmul_rn(dw, dtS[j]), eS[c])
                                       : 0.0f;
                dsum = __fadd_rn(dsum, dj);
                if (j < Q) {
                    const long long at = (static_cast<long long>(bc) * nh + h) *
                                         qp + j;
                    wk.col[at] = __fsub_rn(-p, dj);
                    ddt[(row0 + j) * nh + h] =
                        __fadd_rn(d, __fmul_rn(dw, eS[c]));
                }
            }
#pragma unroll
            for (int m = 16; m > 0; m >>= 1)
                dsum += __shfl_xor_sync(0xffffffffu, dsum, m);
            if (lane == 0)
                wk.dend[(static_cast<long long>(bc) * nh + h) * nt + jt] = dsum;
        }
        __syncthreads();                 // the partial sums read
    }

    // the group's dB partial
    float* out = wk.dbs + (static_cast<long long>(bc) * ng + g) * qp * N;
#pragma unroll
    for (int n8 = 0; n8 < NTB; ++n8) {
        const int c = ch * (N / 2) + n8 * 8 + 2 * lt;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int j = j0 + rs * 16 + lg + 8 * half;
            *reinterpret_cast<float2*>(out + static_cast<long long>(j) * N +
                                       c) =
                make_float2(dbs[n8][2 * half], dbs[n8][2 * half + 1]);
        }
    }
}

// ---------------------------------------------------------------------------
// pass 4: per (chunk, 64-row tile t): dC_t = dcb_t. B and dB_t = dcb_.t^T C
// plus the groups' partials
// ---------------------------------------------------------------------------

template <int N>
__host__ __device__ constexpr int p4_smem_floats() {
    return kT * (kT + 8) + kT * (N + 8);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
ssd_intra_bwd_chunk(const float* __restrict__ Bm,
                    const float* __restrict__ Cm, float* __restrict__ dB,
                    float* __restrict__ dC, Work wk, int Q, int nh) {
    extern __shared__ __align__(16) float smem[];
    constexpr int LDA = kT + 4;          // dcb rows (row-major reads)
    constexpr int LDT = kT + 8;          // dcb read transposed
    constexpr int LDN = N + 8;           // B and C (k-major reads)
    constexpr int NTB = N / 16;
    const int nt = cdiv(Q, kT), qp = nt * kT, ng = cdiv(nh, kHG);
    const int bc = blockIdx.x / nt, t = blockIdx.x % nt;
    const int t0 = t * kT;
    const int tid = threadIdx.x, warp = tid >> 5;
    const int rs = warp & 3, ch = warp >> 2;
    const int lg = lane_g(), lt = lane_t();
    const long long row0 = static_cast<long long>(bc) * Q;
    float* As = smem;
    float* Ns = smem + kT * LDT;
    const float* dcb = wk.dcb + static_cast<long long>(bc) * qp * qp;

    // dC rows t: sum over column tiles kt <= t of dcb[t][kt] B[kt]
    float acc[NTB][4];
    zero(acc);
    for (int kt = 0; kt <= t; ++kt) {
        copy_tile<kT, kT>(As, LDA, kT, [&](int r, int c) {
            return dcb + static_cast<long long>(t0 + r) * qp + kt * kT + c; });
        copy_tile<kT, N>(Ns, LDN, Q - kt * kT, [&](int r, int c) {
            return Bm + (row0 + kt * kT + r) * N + c; });
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < kT; kk += 8) {
            const FragA fa = load_a(As, LDA, rs * 16, kk);
#pragma unroll
            for (int n8 = 0; n8 < NTB; ++n8)
                mma_3x(acc[n8], fa, load_b_kn(Ns, LDN, kk, ch * (N / 2) + n8 * 8));
        }
        __syncthreads();
    }
#pragma unroll
    for (int n8 = 0; n8 < NTB; ++n8) {
        const int c = ch * (N / 2) + n8 * 8 + 2 * lt;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int i = t0 + rs * 16 + lg + 8 * half;
            if (i < Q)
                *reinterpret_cast<float2*>(dC + (row0 + i) * N + c) =
                    make_float2(acc[n8][2 * half], acc[n8][2 * half + 1]);
        }
    }

    // dB rows t: sum over row tiles kt >= t of dcb[kt][t]^T C[kt], plus
    // the sum over groups of their partials, in order
    zero(acc);
    for (int kt = t; kt < nt; ++kt) {
        copy_tile<kT, kT>(As, LDT, kT, [&](int r, int c) {
            return dcb + static_cast<long long>(kt * kT + r) * qp + t0 + c; });
        copy_tile<kT, N>(Ns, LDN, Q - kt * kT, [&](int r, int c) {
            return Cm + (row0 + kt * kT + r) * N + c; });
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < kT; kk += 8) {
            if (kt * kT + kk >= Q) break;
            const FragA fa = load_a_t(As, LDT, rs * 16, kk);
#pragma unroll
            for (int n8 = 0; n8 < NTB; ++n8)
                mma_3x(acc[n8], fa, load_b_kn(Ns, LDN, kk, ch * (N / 2) + n8 * 8));
        }
        __syncthreads();
    }
    const float* dbs = wk.dbs + static_cast<long long>(bc) * ng * qp * N;
#pragma unroll
    for (int n8 = 0; n8 < NTB; ++n8) {
        const int c = ch * (N / 2) + n8 * 8 + 2 * lt;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int j = t0 + rs * 16 + lg + 8 * half;
            if (j >= Q) continue;
            float2 s = *reinterpret_cast<const float2*>(
                dbs + static_cast<long long>(j) * N + c);
            for (int gg = 1; gg < ng; ++gg) {
                const float2 v = *reinterpret_cast<const float2*>(
                    dbs + (static_cast<long long>(gg) * qp + j) * N + c);
                s.x = __fadd_rn(s.x, v.x);
                s.y = __fadd_rn(s.y, v.y);
            }
            *reinterpret_cast<float2*>(dB + (row0 + j) * N + c) =
                make_float2(__fadd_rn(acc[n8][2 * half], s.x),
                            __fadd_rn(acc[n8][2 * half + 1], s.y));
        }
    }
}

// ---------------------------------------------------------------------------
// pass 5: per head, a warp a chunk: dcum assembled into shared memory, da
// its reverse cumsum in double (the lanes over runs of rows, a suffix
// scan across them), ddt += da A, dA = sum of da dt over chunks and rows
// in a fixed order
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
ssd_intra_bwd_finish(const float* __restrict__ dt,
                     const float* __restrict__ A,
                     const float* __restrict__ dcum_in,
                     float* __restrict__ ddt, float* __restrict__ dA, Work wk,
                     int BC, int Q, int nh) {
    constexpr int kWarps = kThreads / 32;
    __shared__ float dc[kWarps][kMaxQ];
    __shared__ double part[kWarps];
    const int h = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nt = cdiv(Q, kT), qp = nt * kT;
    const int per = cdiv(Q, 32);         // rows a lane in the scan
    const int r0 = min(lane * per, Q), r1 = min(r0 + per, Q);
    const float a_h = A[h];
    float* v = dc[warp];
    double total = 0.0;
    for (int bc = warp; bc < BC; bc += kWarps) {
        const long long hb = static_cast<long long>(bc) * nh + h;
        const long long row0 = static_cast<long long>(bc) * Q;
        float dend = 0.0f;
        for (int k = 0; k < nt; ++k)
            dend = __fadd_rn(dend, wk.dend[hb * nt + k]);
        for (int i = lane; i < Q; i += 32) {
            float d = dcum_in[(row0 + i) * nh + h];
            for (int k = 0; k <= i / kT; ++k)
                d = __fadd_rn(d, wk.rowp[(hb * nt + k) * qp + i]);
            d = __fadd_rn(d, wk.col[hb * qp + i]);
            if (i == Q - 1) d = __fadd_rn(d, dend);
            v[i] = d;
        }
        __syncwarp();
        double own = 0.0;
        for (int i = r0; i < r1; ++i) own += static_cast<double>(v[i]);
        // the lanes after this one: an inclusive suffix scan, less own
        double after = own;
#pragma unroll
        for (int m = 1; m < 32; m <<= 1) {
            const double u = __shfl_down_sync(0xffffffffu, after, m);
            if (lane + m < 32) after += u;
        }
        after -= own;
        __syncwarp();
        for (int i = r1 - 1; i >= r0; --i) {
            after += static_cast<double>(v[i]);
            v[i] = static_cast<float>(after);    // da_i
        }
        __syncwarp();
        for (int i = lane; i < Q; i += 32) {
            const long long at = (row0 + i) * nh + h;
            ddt[at] = __fadd_rn(ddt[at], __fmul_rn(v[i], a_h));
            total += static_cast<double>(__fmul_rn(v[i], dt[at]));
        }
        __syncwarp();
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
        total += __shfl_xor_sync(0xffffffffu, total, m);
    if (lane == 0) part[warp] = total;
    __syncthreads();
    if (threadIdx.x == 0) {
        double s = 0.0;
        for (int w = 0; w < kWarps; ++w) s += part[w];
        dA[h] = static_cast<float>(s);
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename K>
int allow_smem(K kernel, int floats) {
    // once per instantiation: the largest shared memory its launches use
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float)) * floats);
    return static_cast<int>(e);
}

template <int HD, int N>
int launch(const float* x, const float* dt, const float* A, const float* B,
           const float* C, const float* dy, const float* dst,
           const float* dcum, float* dx, float* ddt, float* dA, float* dB,
           float* dC, float* work, int BC, int Q, int nh, cudaStream_t st) {
    static_assert(HD % 16 == 0 && N % 16 == 0, "tile shape");
    constexpr int f2 = p2_smem_floats<HD, N>();
    constexpr int f3 = P3<HD, N>::floats;
    constexpr int f4 = p4_smem_floats<N>();
    static bool attr_set = false;
    if (!attr_set) {
        int rc = allow_smem(ssd_intra_bwd_dcb<HD, N>, f2);
        if (rc == 0) rc = allow_smem(ssd_intra_bwd_heads<HD, N>, f3);
        if (rc == 0) rc = allow_smem(ssd_intra_bwd_chunk<N>, f4);
        if (rc != 0) return rc;
        attr_set = true;
    }
    Work wk;
    work_floats(BC, Q, nh, N, &wk, work);
    const long long nt = cdiv(Q, kT), ng = cdiv(nh, kHG);
    const long long blocks[4] = {BC * static_cast<long long>(
                                     cdiv(nh, kCumHeads)),
                                 BC * nt * (nt + 1) / 2, nt * BC * ng,
                                 BC * nt};
    for (long long b : blocks)
        if (b > 0x7fffffffLL) return -4;
    ssd_intra_bwd_cum<<<static_cast<unsigned>(blocks[0]), kThreads, 0, st>>>(
        dt, A, wk, BC, Q, nh);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ssd_intra_bwd_dcb<HD, N><<<static_cast<unsigned>(blocks[1]), kThreads,
                               sizeof(float) * f2, st>>>(x, dt, B, C, dy, wk,
                                                         Q, nh);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ssd_intra_bwd_heads<HD, N><<<static_cast<unsigned>(blocks[2]), kThreads,
                                 sizeof(float) * f3, st>>>(
        x, dt, B, dy, dst, dx, ddt, wk, BC, Q, nh);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ssd_intra_bwd_chunk<N><<<static_cast<unsigned>(blocks[3]), kThreads,
                             sizeof(float) * f4, st>>>(B, C, dB, dC, wk, Q,
                                                       nh);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ssd_intra_bwd_finish<<<nh, kThreads, 0, st>>>(dt, A, dcum, ddt, dA, wk,
                                                  BC, Q, nh);
    return static_cast<int>(cudaGetLastError());
}

template <int HD>
int dispatch_n(int n, const float* x, const float* dt, const float* A,
               const float* B, const float* C, const float* dy,
               const float* dst, const float* dcum, float* dx, float* ddt,
               float* dA, float* dB, float* dC, float* work, int BC, int Q,
               int nh, cudaStream_t st) {
#define SSD_BWD_N(NN)                                                        \
    case NN:                                                                 \
        return launch<HD, NN>(x, dt, A, B, C, dy, dst, dcum, dx, ddt, dA,    \
                              dB, dC, work, BC, Q, nh, st);
    switch (n) {
        SSD_BWD_N(16) SSD_BWD_N(32) SSD_BWD_N(64) SSD_BWD_N(128)
        default: return -2;
    }
#undef SSD_BWD_N
}

}  // namespace

// floats of scratch `ssd_intra_bwd` takes at these sizes
extern "C" long long ssd_intra_bwd_work(int BC, int Q, int nh, int n) {
    return work_floats(BC, Q, nh, n, nullptr, nullptr);
}

extern "C" int ssd_intra_bwd(const void* x, const void* dt, const void* A,
                             const void* B, const void* C, const void* dy,
                             const void* dstates, const void* dcum, void* dx,
                             void* ddt, void* dA, void* dB, void* dC,
                             void* work, int BC, int Q, int nh, int hd, int n,
                             void* stream) {
    if (BC < 1 || Q < 1 || Q > kMaxQ || nh < 1) return -3;
    if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(B) |
          reinterpret_cast<uintptr_t>(C) | reinterpret_cast<uintptr_t>(dy) |
          reinterpret_cast<uintptr_t>(dstates) |
          reinterpret_cast<uintptr_t>(work)) & 15) != 0)
        return -5;
    const float* f[8] = {static_cast<const float*>(x),
                         static_cast<const float*>(dt),
                         static_cast<const float*>(A),
                         static_cast<const float*>(B),
                         static_cast<const float*>(C),
                         static_cast<const float*>(dy),
                         static_cast<const float*>(dstates),
                         static_cast<const float*>(dcum)};
    float* o[6] = {static_cast<float*>(dx), static_cast<float*>(ddt),
                   static_cast<float*>(dA), static_cast<float*>(dB),
                   static_cast<float*>(dC), static_cast<float*>(work)};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSD_BWD_HD(HH)                                                       \
    case HH:                                                                 \
        return dispatch_n<HH>(n, f[0], f[1], f[2], f[3], f[4], f[5], f[6],   \
                              f[7], o[0], o[1], o[2], o[3], o[4], o[5], BC,  \
                              Q, nh, st);
    switch (hd) {
        SSD_BWD_HD(16) SSD_BWD_HD(32) SSD_BWD_HD(64) SSD_BWD_HD(128)
        default: return -2;
    }
#undef SSD_BWD_HD
}
