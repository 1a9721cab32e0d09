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
// before any product. `cum` is recomputed here from the float products
// dt * A summed in double and rounded once a row, as the forward forms
// it (the order of the double adds does not show at float32), so the
// Function saves only its inputs.
//
// Bound on this card: operations. At mamba2-370m's training shape (Bt 2,
// nc 8, Q 256, nh 32, hd 64, N 128) the causal half of dS, S^T dy, dcb B
// and dcb^T C, with C B^T and the full B dst^T and (w x) dst, are some
// 10 GFLOP against some 128 MB in and out. Every product runs on the
// tensor cores in 3xTF32 (each float32 operand split into a big and a
// small TF32 part; small a big b + big a small b + big a big b into one
// float32 accumulator; plain TF32 would miss the float32-level check): 3
// x 10 GFLOP at the TF32 rate. The decay, the mask and every sum stay in
// float32 on the CUDA cores.
//
// Three launches; no atomics, so two calls give the same bits (every
// cross-head and cross-chunk sum is a set of partials added in a fixed
// order):
//  1. prep, a persistent grid of as many blocks as the card holds at
//     once, walking C B^T's tiles (per chunk, each 64 x 64 tile on or
//     below the diagonal; 8 warps, mma.sync), then cum a warp per (chunk,
//     head): the lanes sum runs of rows in double, a scan across the
//     lanes gives each run its start (a chain of Q/32 adds, not Q);
//  2. heads, per (chunk, group of heads, 64-column tile j), the heaviest
//     tiles (smallest j) first: per head, B dst^T gives dx's state term
//     and dw, (w x) dst adds to the group's dB partial; then per row tile
//     i >= j, dS = dy x^T is formed once, and from its registers S, P,
//     their row and column sums, and dcb's term dS dt_j e, which is added
//     into the group's dcb partial in scratch (the group's first head
//     stores, the others add, in head order); dx += S^T dy;
//  3. chunk: per (chunk, 64-row tile, dC or dB, half of N at N >= 64), 8
//     warps, mma.sync: dC = dcb B and dB = dcb^T C plus the groups' dB
//     partials, each dcb tile the sum of the groups' partials in group
//     order; the blocks after those finish one head each: dcum assembled
//     (a lane's loads all issued before its sums), its reverse cumsum in
//     double (a warp a chunk), ddt completed, dA summed over chunks in a
//     fixed order. A wgmma form of this pass (the dcb tile and B or C
//     split into planes, transposed where their contraction runs along
//     their rows) measured slower on an H100 (0.056 against 0.045 ms at
//     mamba2-370m's shape): its steps wait on the sums of the groups'
//     partials, not on the products.
// Scratch (`ssd_intra_bwd_work` floats, sized for groups of 4 heads, the
// most groups either form makes): cum, C B^T's tiles, the dcb partials
// (BC, ng, Qp, Qp) (Qp = Q in whole tiles; in the wgmma form's groups of
// 8, 16.8 MB at mamba2-370m's shape and 33.5 MB at zamba2-1.2b's), the dB
// partials (BC, ng, Qp, N) and the row and column sums: 57.7 MB in all at
// mamba2-370m's shape, 94.4 MB at zamba2-1.2b's.
//
// Pass 2 at hd 64 with N 64 and 128 (the training widths): wgmma, groups
// of 8 heads.
// - Two warpgroups a block, each 32 of the tile's 64 columns; one block
//   an SM (219 KiB of shared memory at N 128, 171 at N 64). Every product
//   is `wgmma.mma_async.m64n32k8.f32.tf32.tf32`, 3 a k-step.
// - Each operand is split once into its big and small planes when its
//   tile lands, written in the 128-byte-swizzled K-major layout the
//   descriptors read (32-column boxes of 64 rows x 128 bytes, a row's
//   16-byte chunks XORed with the row mod 8): B_j once a block, x_j and w
//   x_j once a head, dy_i once a row tile. `.tf32` takes K-major operands
//   only (the transpose bits are for 16-bit types), so each product is
//   oriented so that its B is K-major as stored, and its A is read
//   transposed where it must be:
//     V^T (hd x j) = dst B_j^T       A dst, from registers  B B_j
//     dB^T (N x j) += dst^T (w x)^T  A dst read transposed  B w x_j
//     dS (i x j) = dy_i x_j^T        A dy_i's planes        B x_j
//     dx^T (hd x j) += dy_i^T S      A dy_i's planes read   B S^T
//                                      transposed, bits as split
//   dst's A fragments are read from its float32 tile and split in
//   registers by each warpgroup (its planes, 64 KiB at N 128, do not fit
//   beside the rest). S^T's planes are the one operand written
//   transposed: the epilogue stores S (rows i, columns j in the
//   accumulator) at row j, column i, the warp's 32 values in 32 banks.
//   dx and dB's partial are kept transposed (columns j) and stored so; dw
//   reads x from its planes (big + small, within 2^-22 of x).
// - Tiles come through one landing tile (cp.async, completion counted
//   on an mbarrier) and dst's buffer: the next row tile's dy lands while
//   this one's products and epilogue run, the next head's x_j, cum and dt
//   during the head's last row tile, its dst during all of them. Each row
//   tile's C B^T entries and dcb partial are read into registers while
//   the tile before runs its dx^T product (the first tile's while the
//   head's two products run), and that product's wait comes after them.
// - Accumulators a thread: dx^T 16, the dB^T partial 16 N/64, dS 16; a
//   product's A fragments, 64, live for its 8 k-steps: 255 registers at N
//   128, 250 at N 64, no spills. The mask is applied by selects, with
//   exp(0) where masked. The column sums of P and of dS cb e go to
//   shared memory each row tile, reduced over the warp's rows by a
//   reduce-scatter (7 shuffles for 8 columns). The barrier waits spin
//   with no timer.
// Pass 2 at the other widths (hd or N 16 or 32, hd 128; no training
// path runs them): the first design, mma.sync m16n8k8 TF32 with each
// operand split in registers, 8 warps, groups of 4 heads, dS likewise
// formed once and feeding the group's dcb partial.
// Tiles come from device memory by 16-byte cp.async copies, so x, dy, B,
// C and dstates must start 16-byte aligned (the C entry returns -5
// otherwise; the wrapper copies an unaligned input into a fresh buffer).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // the mma.sync passes: 8 warps
constexpr int kWgThreads = 128;  // the wgmma head pass: one warpgroup
constexpr int kT = 64;           // tile rows and columns
constexpr int kHG = 4;           // heads a block of pass 2 (mma.sync)
constexpr int kHGW = 8;          // the same, the wgmma form
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
// row g + 8 * half, column 2 t + e. A warpgroup's m64 fragments are four
// of these, warp w at rows 16 w..
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

// 4 bytes: dst = valid ? *src : 0, issued, not waited for
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

// once every group but the newest has landed
__device__ __forceinline__ void cp_async_wait_prev() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A ROWS x COLS tile into shared memory by NT threads, dst[r * ld + c] =
// *src(r, c), rows at or past `rows` as zeros: issued, not waited for
template <int ROWS, int COLS, int NT = kThreads, typename Src>
__device__ __forceinline__ void copy_tile(float* dst, int ld, int rows,
                                          Src src) {
    static_assert(COLS % 4 == 0, "tile shape");
    constexpr int CV = COLS / 4, NV = ROWS * CV;
#pragma unroll
    for (int k = 0; k < cdiv(NV, NT); ++k) {
        const int e = threadIdx.x + k * NT;
        if (NV % NT == 0 || e < NV) {
            const int r = e / CV, c = (e % CV) * 4;
            const bool ok = r < rows;
            cp_async_f32x4(dst + r * ld + c, src(ok ? r : 0, c), ok);
        }
    }
}

// ---------------------------------------------------------------------------
// the scratch: one float32 buffer, its parts by (BC, Q, nh, N); Qp is Q
// padded to whole tiles, ng the head groups of pass 2 (sized for kHG, the
// smaller group)
// ---------------------------------------------------------------------------

struct Work {
    int ng;          // head groups: nh / kHG (mma.sync) or nh / kHGW
    float* cum;      // (BC, nh, Qp): cum per (chunk, head)
    float* cb;       // (BC, Qp, Qp): C B^T, tiles on and below the diagonal
    float* dcbp;     // (BC, ng, Qp, Qp): per group, sum over its heads of
                     // dS dt_j e, the same tiles
    float* dbs;      // (BC, ng, Qp, N): sum over a group's heads of (w x) dst
    float* rowp;     // (BC, nh, nt, Qp): row sums of P over a column tile
    float* col;      // (BC, nh, Qp): -(column sums of P) - d
    float* dend;     // (BC, nh, nt): sum of d over a column tile
};

// the scratch's floats; with `w`, its parts' pointers into `base`
long long work_floats(int BC, int Q, int nh, int n, Work* w, float* base) {
    const long long nt = cdiv(Q, kT), qp = nt * kT, ng = cdiv(nh, kHG);
    const long long sizes[7] = {BC * nh * qp, BC * qp * qp, BC * ng * qp * qp,
                                BC * ng * qp * n, BC * nh * nt * qp,
                                BC * nh * qp, BC * nh * nt};
    float** parts[7] = {nullptr, nullptr, nullptr, nullptr, nullptr,
                        nullptr, nullptr};
    if (w != nullptr) {
        parts[0] = &w->cum; parts[1] = &w->cb; parts[2] = &w->dcbp;
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
// pass 1: per (chunk, tile (it, jt) with jt <= it) cb = C B^T; then, a
// warp per (chunk, head), cum; the items walked by a persistent grid
// ---------------------------------------------------------------------------

constexpr int kWarps = kThreads / 32;

template <int N>
__host__ __device__ constexpr int prep_smem_floats() {
    return 2 * kT * (N + 4);
}

// cum of (chunk, head) `item`, one warp: each lane sums its run of rows'
// float products in double, an exclusive scan across the lanes in double
// gives the run its start, each row rounded once; rows past Q are 0
__device__ __forceinline__ void cum_rows(const float* __restrict__ dt,
                                         const float* __restrict__ A,
                                         Work wk, int Q, int nh, int qp,
                                         int item) {
    const int lane = threadIdx.x & 31;
    const int bc = item / nh, h = item % nh;
    const int per = cdiv(Q, 32);
    const int r0 = min(lane * per, Q), r1 = min(r0 + per, Q);
    const float a_h = A[h];
    const float* d = dt + static_cast<long long>(bc) * Q * nh + h;
    float prod[cdiv(kMaxQ, 32)];
    double own = 0.0;
#pragma unroll
    for (int k = 0; k < cdiv(kMaxQ, 32); ++k) {
        const int i = r0 + k;
        prod[k] = i < r1 ? __fmul_rn(d[static_cast<long long>(i) * nh], a_h)
                         : 0.0f;
        own += static_cast<double>(prod[k]);
    }
    double inc = own;
#pragma unroll
    for (int m = 1; m < 32; m <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, inc, m);
        if (lane >= m) inc += u;
    }
    double c = __shfl_up_sync(0xffffffffu, inc, 1);
    if (lane == 0) c = 0.0;
    float* out = wk.cum + (static_cast<long long>(bc) * nh + h) * qp;
#pragma unroll
    for (int k = 0; k < cdiv(kMaxQ, 32); ++k) {
        c += static_cast<double>(prod[k]);
        if (r0 + k < r1) out[r0 + k] = static_cast<float>(c);
    }
    for (int i = Q + lane; i < qp; i += 32) out[i] = 0.0f;
}

// C B^T's tile `pr` (in order (0,0), (1,0), (1,1), (2,0), ...) of chunk
// bc: each warp a 16 x 32 block
template <int N>
__device__ __forceinline__ void cb_tile(const float* __restrict__ Bm,
                                        const float* __restrict__ Cm,
                                        Work wk, int Q, int bc, int pr,
                                        float* smem) {
    constexpr int LDN = N + 4;
    const int qp = cdiv(Q, kT) * kT;
    int it = 0;
    while (pr > it) { pr -= it + 1; ++it; }
    const int jt = pr;
    const int i0 = it * kT, j0 = jt * kT;
    const int tid = threadIdx.x, warp = tid >> 5;
    const int rs = warp & 3, ch = warp >> 2;
    const int lg = lane_g(), lt = lane_t();
    const long long row0 = static_cast<long long>(bc) * Q;
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
            *reinterpret_cast<float2*>(out + static_cast<long long>(i) * qp +
                                       j) =
                make_float2(acc[n8][2 * half], acc[n8][2 * half + 1]);
        }
    }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
ssd_intra_bwd_prep(const float* __restrict__ dt, const float* __restrict__ A,
                   const float* __restrict__ Bm, const float* __restrict__ Cm,
                   Work wk, int BC, int Q, int nh) {
    extern __shared__ __align__(16) float smem[];
    const int nt = cdiv(Q, kT), qp = nt * kT;
    const int npairs = nt * (nt + 1) / 2;
    const long long ncb = static_cast<long long>(BC) * npairs;
    const long long items = ncb + cdiv(BC * nh, kWarps);
    for (long long item = blockIdx.x; item < items; item += gridDim.x) {
        if (item >= ncb) {
            const long long c = (item - ncb) * kWarps + (threadIdx.x >> 5);
            if (c < static_cast<long long>(BC) * nh)
                cum_rows(dt, A, wk, Q, nh, qp, static_cast<int>(c));
        } else {
            cb_tile<N>(Bm, Cm, wk, Q, static_cast<int>(item / npairs),
                       static_cast<int>(item % npairs), smem);
            __syncthreads();             // the tiles read
        }
    }
}

// ---------------------------------------------------------------------------
// pass 2, the mma.sync form: per (chunk, group of kHG heads, column tile
// jt)
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
    const int nt = cdiv(Q, kT), qp = nt * kT, ng = wk.ng;
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
    float* dcbp = wk.dcbp + (static_cast<long long>(bc) * ng + g) * qp * qp;

    copy_tile<kT, N>(Bs, LDN, Q - j0, [&](int r, int c) {
        return Bm + (row0 + j0 + r) * N + c; });
    cp_async_commit();

    float dbs[NTB][4];
    zero(dbs);
    const int h0 = g * kHG, h_end = min(nh, h0 + kHG);
    for (int h = h0; h < h_end; ++h) {
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

        // row tiles i >= j: dS once, then S, P, dcb's term; dx += S^T dy
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
                    float s = 0.0f, dc = 0.0f;
                    if (i < Q && j <= i) {   // masked before exp
                        const float el = expf(__fsub_rn(cumS[i], cumS[j]));
                        const float dtj = dtS[j];
                        const float ds_ = acc[n8][e];
                        const float cbl = __fmul_rn(cbv[n8][e], el);
                        s = __fmul_rn(cbl, dtj);
                        const float t1 = __fmul_rn(ds_, dtj);
                        dc = __fmul_rn(t1, el);
                        const float p = __fmul_rn(__fmul_rn(t1, cbv[n8][e]), el);
                        colp[n8][e & 1] = __fadd_rn(colp[n8][e & 1], p);
                        cold[n8][e & 1] = __fadd_rn(cold[n8][e & 1],
                                                    __fmul_rn(ds_, cbl));
                        rowp[e >> 1] = __fadd_rn(rowp[e >> 1], p);
                    }
                    Ss[li * LDS + lj] = s;
                    acc[n8][e] = dc;     // dS spent: dcb's term in its place
                }
            // the group's dcb partial: its first head stores, the others
            // add, in head order
            float2 prev[4][2];
            if (h > h0) {
#pragma unroll
                for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
                    for (int half = 0; half < 2; ++half)
                        prev[n8][half] = *reinterpret_cast<const float2*>(
                            dcbp + static_cast<long long>(
                                       i0 + rs * 16 + lg + 8 * half) * qp +
                            j0 + ch * 32 + n8 * 8 + 2 * lt);
            }
#pragma unroll
            for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    float2 v = make_float2(acc[n8][2 * half],
                                           acc[n8][2 * half + 1]);
                    if (h > h0) {
                        v.x = __fadd_rn(prev[n8][half].x, v.x);
                        v.y = __fadd_rn(prev[n8][half].y, v.y);
                    }
                    *reinterpret_cast<float2*>(
                        dcbp + static_cast<long long>(
                                   i0 + rs * 16 + lg + 8 * half) * qp +
                        j0 + ch * 32 + n8 * 8 + 2 * lt) = v;
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
// pass 2, the wgmma form (hd 64; N 64 and 128)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

// an arrive on `bar` once every cp.async this thread has issued landed
// (the barrier counts every thread of the block)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(bar) : "memory");
}

// this thread's writes to shared memory visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products
template <int NR>
__device__ __forceinline__ void fence_regs(float (&r)[NR]) {
#pragma unroll
    for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// and a fragment's registers live until its products completed
__device__ __forceinline__ void fence_frag(FragA& f) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
        asm volatile("" : "+r"(f.big[i]), "+r"(f.small[i]) :: "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), the 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32
         | static_cast<uint64_t>(1) << 62;
}

// A plane: 64 rows of K float32 (TF32 bits), K-major, the 128-byte
// swizzle: K/32 boxes of 64 rows x 128 bytes (8 KiB, 1 KiB aligned), the
// 16-byte chunks of a row XORed with the row mod 8. Its big plane is
// followed by its small plane.
constexpr int kBox = kT * 128;

// byte offset of (row r, column c) in a plane
__device__ __forceinline__ uint32_t plane_off(int r, int c) {
    return (c >> 5) * kBox + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) +
           (c & 3) * 4;
}

// k-step kk (8 columns, 32 bytes into a 128-byte row) of the plane's rows
// from `row0` (a multiple of 8) as an operand
__device__ __forceinline__ uint64_t pdesc(uint32_t plane, int row0, int kk) {
    return desc(plane + (kk >> 2) * kBox + row0 * 128 + (kk & 3) * 32, 16,
                1024);
}

// four columns c.. (c % 4 == 0) of row r split into the big plane at
// `plane` and the small one pb bytes after it
__device__ __forceinline__ void put4(char* plane, int pb, int r, int c,
                                     float4 v) {
    uint4 big, small;
    split(v.x, big.x, small.x);
    split(v.y, big.y, small.y);
    split(v.z, big.z, small.z);
    split(v.w, big.w, small.w);
    const uint32_t o = plane_off(r, c);
    *reinterpret_cast<uint4*>(plane + o) = big;
    *reinterpret_cast<uint4*>(plane + pb + o) = small;
}

__device__ __forceinline__ void put1(char* plane, int pb, int r, int c,
                                     float v) {
    uint32_t big, small;
    split(v, big, small);
    const uint32_t o = plane_off(r, c);
    *reinterpret_cast<uint32_t*>(plane + o) = big;
    *reinterpret_cast<uint32_t*>(plane + pb + o) = small;
}

#define WG_D8(o)                                                              \
    "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),               \
    "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define WG_D16(o) WG_D8(o), WG_D8(o + 8)

// D (64 x 32, float32) += A (registers, TF32) * B (shared memory,
// K-major); accumulator d[4 n8 + e] at row 16 w + g + 8 (e / 2), column
// 8 n8 + 2 t + e % 2 (w the warp of the warpgroup); A's a[i] at row 16 w
// + g + 8 (i % 2), k t + 4 (i / 2)
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : WG_D16(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, float32) += A (shared memory, K-major) * B (the same)
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n}\n"
        : WG_D16(0)
        : "l"(da), "l"(db), "r"(1));
}

#undef WG_D16
#undef WG_D8

// A (64 x 8) of k-step k0/8 from a plane stored with K as its rows (the
// operand is the plane's transpose): element (m, k) at the plane's (row
// k, column m), its big and small bits read, not split again
__device__ __forceinline__ FragA load_a_plane_t(const char* plane, int pb,
                                                int r0, int k0) {
    const int g = lane_g(), t = lane_t();
    const int m[4] = {r0 + g, r0 + g + 8, r0 + g, r0 + g + 8};
    const int k[4] = {k0 + t, k0 + t, k0 + t + 4, k0 + t + 4};
    FragA f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const uint32_t o = plane_off(k[i], m[i]);
        f.big[i] = *reinterpret_cast<const uint32_t*>(plane + o);
        f.small[i] = *reinterpret_cast<const uint32_t*>(plane + pb + o);
    }
    return f;
}

// acc (64 x 32) += A B in 3xTF32 (small a big b, big a small b, big a big
// b, as mma_3x), B (K x 32) the plane at `pbase` rows nrow.. (N of the
// product, K its columns): A (64 x K) from registers, rows m0.. of
//  - SRC 0: a float32 tile in shared memory, (m, k) at s[m * ld + k],
//    read and split here;
//  - SRC 1: the same at s[k * ld + m];
// or, SRC 3, A the plane at `pa` rows m0.. (K its columns), both
// operands' descriptors. 8 k-steps (24 products) a group, each group
// waited for before the next one's fragments are loaded.
template <int K, int SRC>
__device__ __forceinline__ void wg_product(float (&acc)[16], const float* s,
                                           int ld, uint32_t pa, int m0,
                                           uint32_t pbase, int nrow, int pb) {
    const int r0 = m0 + 16 * ((threadIdx.x >> 5) & 3);
#pragma unroll
    for (int kc = 0; kc < K; kc += 64) {
        FragA a[8];
        if constexpr (SRC != 3) {
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                if constexpr (SRC == 0) a[k] = load_a(s, ld, r0, kc + 8 * k);
                else a[k] = load_a_t(s, ld, r0, kc + 8 * k);
            }
        }
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const uint64_t db = pdesc(pbase, nrow, kc / 8 + k);
            const uint64_t dbs = db + static_cast<uint64_t>(pb >> 4);
            if constexpr (SRC == 3) {
                const uint64_t da = pdesc(pa, m0, kc / 8 + k);
                const uint64_t das = da + static_cast<uint64_t>(pb >> 4);
                wgmma_ss(acc, das, db);
                wgmma_ss(acc, da, dbs);
                wgmma_ss(acc, da, db);
            } else {
                wgmma_rs(acc, a[k].small, db);
                wgmma_rs(acc, a[k].big, dbs);
                wgmma_rs(acc, a[k].big, db);
            }
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        if constexpr (SRC != 3) {
#pragma unroll
            for (int k = 0; k < 8; ++k) fence_frag(a[k]);
        }
    }
}

// v[2 n8 + k]: a value of column 8 n8 + 2 t + k (n8 < 4) from each lane
// of the warp; summed over the 8 lanes g of each t and scattered: lane
// (g, t) keeps the sum of column 8 (g / 2) + 2 t + g % 2. Three rounds
// (4, 2, 1 shuffles) in a fixed order.
__device__ __forceinline__ float reduce_scatter8(const float (&v)[8]) {
    const int lg = lane_g();
    const bool b2 = lg & 4, b1 = lg & 2, b0 = lg & 1;
    float a4[4], a2[2];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const float send = b2 ? v[k] : v[k + 4];
        const float keep = b2 ? v[k + 4] : v[k];
        a4[k] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 16));
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        const float send = b1 ? a4[k] : a4[k + 2];
        const float keep = b1 ? a4[k + 2] : a4[k];
        a2[k] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 8));
    }
    const float send = b0 ? a2[0] : a2[1];
    const float keep = b0 ? a2[1] : a2[0];
    return __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 4));
}

// the column (of the warpgroup's 32) whose sum reduce_scatter8 leaves
// with this lane
__device__ __forceinline__ int scatter_col() {
    const int lg = lane_g();
    return 8 * (lg >> 1) + 2 * lane_t() + (lg & 1);
}

template <int HD, int N>
struct WgL {
    static_assert(HD == 64 && (N == 64 || N == 128), "the wgmma widths");
    static constexpr int LDD = N + 4;    // dst (HD x N) and B_j, float32
    static constexpr int LDL = kT + 4;   // the landing tile: x_j or dy_i
    static constexpr int PB_B = kT * N * 4;     // a plane of B_j
    static constexpr int PB_X = kT * kT * 4;    // of x_j, w x_j, dy_i, S^T
    // byte offsets from the 1 KiB aligned base: planes of B_j, x_j, dy_i,
    // then w x_j's (per head) in the place of S^T's (per row tile); dst
    // (B_j first), the landing tile; the vectors, the barriers
    static constexpr int bp = 0;
    static constexpr int xp = bp + 2 * PB_B;
    static constexpr int yp = xp + 2 * PB_X;
    static constexpr int wp = yp + 2 * PB_X;
    static constexpr int df = wp + 2 * PB_X;
    static constexpr int land = df + HD * LDD * 4;
    static constexpr int vec = land + kT * LDL * 4;
    // cum and dt of this head and the next (2 x 2 x kMaxQ), w and
    // exp(cum_end - cum) of the tile's rows, column sums of P and of dS cb
    // e (2 x 4 warps x 64), dw's (4 x 64), P's row sums (2 warpgroups x
    // 64)
    static constexpr int vec_floats =
        4 * kMaxQ + 2 * kT + 8 * kT + 4 * kT + 2 * kT;
    static constexpr int bar = vec + vec_floats * 4;
    static constexpr int bytes = bar + 2 * 8 + 1024;
    static_assert(bytes <= 232448, "a block's shared memory exceeds 227 KiB");
};

template <int HD, int N>
__global__ void __launch_bounds__(2 * kWgThreads, 1)
ssd_intra_bwd_heads_wg(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ Bm,
                       const float* __restrict__ dy,
                       const float* __restrict__ dst, float* __restrict__ dx,
                       float* __restrict__ ddt, Work wk, int BC, int Q,
                       int nh) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    using L = WgL<HD, N>;
    constexpr int NT = 2 * kWgThreads;
    constexpr int LDD = L::LDD, LDL = L::LDL;
    constexpr int MT = N / 64;           // 64-row tiles of dB^T
    const uint32_t raw = smem_u32(smem_raw);
    char* sm = reinterpret_cast<char*>(smem_raw) +
               (((raw + 1023u) & ~1023u) - raw);
    const uint32_t sa = smem_u32(sm);
    const int nt = cdiv(Q, kT), qp = nt * kT, ng = wk.ng;
    const long long per = static_cast<long long>(BC) * ng;
    const int jt = static_cast<int>(blockIdx.x / per);     // heaviest first
    const int rem = static_cast<int>(blockIdx.x % per);
    const int bc = rem / ng, g = rem % ng;
    const int j0 = jt * kT;
    const int tid = threadIdx.x, lane = tid & 31;
    const int wg = tid >> 7;             // the warpgroup: columns 32 wg..
    const int w = (tid >> 5) & 3;        // the warp in it: rows 16 w..
    const int lg = lane_g(), lt = lane_t();
    const int jh = 32 * wg;
    const long long row0 = static_cast<long long>(bc) * Q;
    float* Df = reinterpret_cast<float*>(sm + L::df);
    float* Lf = reinterpret_cast<float*>(sm + L::land);
    float* vecb = reinterpret_cast<float*>(sm + L::vec);    // [2][cum, dt]
    float* wS = vecb + 4 * kMaxQ;        // w of the tile's rows
    float* eS = wS + kT;                 // exp(cum_end - cum) of them
    float* colred = eS + kT;             // [2][4][64]: P, dS cb e
    float* dwred = colred + 8 * kT;      // [4][64]
    float* rowred = dwred + 4 * kT;      // [2][64]
    const char* xpl = sm + L::xp;
    const uint32_t bp = sa + L::bp, xp = sa + L::xp, yp = sa + L::yp,
                   wp = sa + L::wp;
    const uint32_t bar_d = sa + L::bar;      // dst (or B_j) landed
    const uint32_t bar_l = bar_d + 8;        // the landing tile landed
    const float* cbt = wk.cb + static_cast<long long>(bc) * qp * qp;
    float* dcbp = wk.dcbp + (static_cast<long long>(bc) * ng + g) * qp * qp;
    const int h0 = g * kHGW, h_end = min(nh, h0 + kHGW);

    if (tid == 0) {
        mbar_init(bar_d, NT);
        mbar_init(bar_l, NT);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    uint32_t ph_d = 0, ph_l = 0;         // the barriers' next parities

    auto issue_dst = [&](int h) {
        copy_tile<HD, N, NT>(Df, LDD, HD, [&](int r, int c) {
            return dst + ((static_cast<long long>(bc) * nh + h) * HD + r) * N +
                   c; });
        cp_async_arrive(bar_d);
    };
    // x_j of head h into the landing tile, its cum and dt into vector
    // buffer h - h0 mod 2
    auto issue_x = [&](int h) {
        copy_tile<kT, HD, NT>(Lf, LDL, Q - j0, [&](int r, int c) {
            return x + ((row0 + j0 + r) * nh + h) * HD + c; });
        float* cv = vecb + ((h - h0) & 1) * 2 * kMaxQ;
        const float* cum = wk.cum + (static_cast<long long>(bc) * nh + h) * qp;
        for (int e = tid; e < qp / 4; e += NT)
            cp_async_f32x4(cv + 4 * e, cum + 4 * e, true);
        for (int i = tid; i < qp; i += NT)
            cp_async_f32(cv + kMaxQ + i, dt + (row0 + min(i, Q - 1)) * nh + h,
                         i < Q);
        cp_async_arrive(bar_l);
    };
    auto issue_dy = [&](int h, int it) {
        copy_tile<kT, HD, NT>(Lf, LDL, Q - it * kT, [&](int r, int c) {
            return dy + ((row0 + it * kT + r) * nh + h) * HD + c; });
        cp_async_arrive(bar_l);
    };
    auto land = [&](uint32_t bar, uint32_t& ph) {
        mbar_wait(bar, ph);
        ph ^= 1u;
    };
    // x_jp from its planes: big + small, within 2^-22 of x
    auto xval = [&](int j, int p) {
        const uint32_t o = plane_off(j, p);
        return __fadd_rn(
            __uint_as_float(*reinterpret_cast<const uint32_t*>(xpl + o)),
            __uint_as_float(
                *reinterpret_cast<const uint32_t*>(xpl + L::PB_X + o)));
    };

    // B_j through dst's buffer into its planes, once a block
    copy_tile<kT, N, NT>(Df, LDD, Q - j0, [&](int r, int c) {
        return Bm + (row0 + j0 + r) * N + c; });
    cp_async_arrive(bar_d);
    issue_x(h0);
    land(bar_d, ph_d);
    for (int e = tid; e < kT * N / 4; e += NT) {
        const int r = e / (N / 4), c = (e % (N / 4)) * 4;
        put4(sm + L::bp, L::PB_B, r, c,
             *reinterpret_cast<const float4*>(Df + r * LDD + c));
    }
    __syncthreads();                     // dst's buffer read
    issue_dst(h0);

    float db[MT][16];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 16; ++i) db[mt][i] = 0.0f;
    for (int h = h0; h < h_end; ++h) {
        const float* cumS = vecb + ((h - h0) & 1) * 2 * kMaxQ;
        const float* dtS = cumS + kMaxQ;
        for (int i = tid; i < 8 * kT; i += NT) colred[i] = 0.0f;
        land(bar_l, ph_l);               // x_j, cum and dt
        __syncthreads();
        if (tid < kT) {
            const float e = j0 + tid < Q
                                ? expf(__fsub_rn(cumS[Q - 1], cumS[j0 + tid]))
                                : 0.0f;
            eS[tid] = e;
            wS[tid] = __fmul_rn(e, dtS[j0 + tid]);
        }
        __syncthreads();
        // x_j into its planes and w x_j into theirs (x * w as the plain
        // version forms it)
#pragma unroll
        for (int e = tid; e < kT * HD / 4; e += NT) {
            const int r = e / (HD / 4), c = (e % (HD / 4)) * 4;
            const float4 v = *reinterpret_cast<const float4*>(Lf + r * LDL + c);
            const float wr = wS[r];
            put4(sm + L::xp, L::PB_X, r, c, v);
            put4(sm + L::wp, L::PB_X, r, c,
                 make_float4(__fmul_rn(v.x, wr), __fmul_rn(v.y, wr),
                             __fmul_rn(v.z, wr), __fmul_rn(v.w, wr)));
        }
        fence_async_smem();
        __syncthreads();                 // the planes; the landing tile free
        issue_dy(h, jt);
        land(bar_d, ph_d);               // dst
        // a row tile's C B^T entries and dcb partial so far (read at
        // every head, used past the group's first): the first tile's in
        // flight through this head's two products, each next one's
        // while the tile before runs its dx^T product
        float2 cb2[4][2], prev[4][2];
        auto prefetch = [&](int i0) {
#pragma unroll
            for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const long long at =
                        static_cast<long long>(i0 + 16 * w + lg + 8 * half) *
                        qp + j0 + jh + n8 * 8 + 2 * lt;
                    cb2[n8][half] = *reinterpret_cast<const float2*>(cbt + at);
                    prev[n8][half] = *reinterpret_cast<const float2*>(dcbp + at);
                }
        };
        prefetch(j0);

        // V^T = dst B_j^T, the warpgroup's 32 columns: dw, then dx's
        // state term w_j V_jp
        float dxa[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) dxa[i] = 0.0f;
        wg_product<N, 0>(dxa, Df, LDD, 0, 0, bp, jh, L::PB_B);
        {
            // dw_j = sum_p x_jp V_jp: the warp's 16 rows p, then the 4
            // warps in order
            float v[8];
#pragma unroll
            for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
                for (int k = 0; k < 2; ++k) {
                    const int j = jh + n8 * 8 + 2 * lt + k, p = 16 * w + lg;
                    v[2 * n8 + k] = __fadd_rn(
                        __fmul_rn(dxa[4 * n8 + k], xval(j, p)),
                        __fmul_rn(dxa[4 * n8 + 2 + k], xval(j, p + 8)));
                }
            dwred[w * kT + jh + scatter_col()] = reduce_scatter8(v);
        }
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                dxa[4 * n8 + e] = __fmul_rn(
                    dxa[4 * n8 + e], wS[jh + n8 * 8 + 2 * lt + (e & 1)]);
        // the group's dB^T partial += dst^T (w x_j)^T, the warpgroup's
        // columns
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
            wg_product<HD, 1>(db[mt], Df, LDD, 0, 64 * mt, wp, jh, L::PB_X);
        __syncthreads();                 // dst and w x_j read
        if (h + 1 < h_end) issue_dst(h + 1);

        // row tiles i >= j: dS once, then S, P and dcb's term from its
        // registers; dx^T += dy_i^T S
        land(bar_l, ph_l);
        for (int it = jt; it < nt; ++it) {
            const int i0 = it * kT;
#pragma unroll
            for (int e = tid; e < kT * HD / 4; e += NT) {
                const int r = e / (HD / 4), c = (e % (HD / 4)) * 4;
                put4(sm + L::yp, L::PB_X, r, c,
                     *reinterpret_cast<const float4*>(Lf + r * LDL + c));
            }
            fence_async_smem();
            __syncthreads();             // dy_i's planes; the landing free
            if (it + 1 < nt) issue_dy(h, it + 1);
            else if (h + 1 < h_end) issue_x(h + 1);
            // dS = dy_i x_j^T, the warpgroup's 32 columns
            float acc[16];
#pragma unroll
            for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
            wg_product<HD, 3>(acc, nullptr, 0, yp, 0, xp, jh, L::PB_X);

            // cum of the thread's 2 rows, cum and dt of its 8 columns
            float ci[2], cj[8], dj[8];
#pragma unroll
            for (int half = 0; half < 2; ++half)
                ci[half] = cumS[i0 + 16 * w + lg + 8 * half];
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                const int j = j0 + jh + (c >> 1) * 8 + 2 * lt + (c & 1);
                cj[c] = cumS[j];
                dj[c] = dtS[j];
            }
            float pc[8], qc[8], rowp[2] = {0.0f, 0.0f};
#pragma unroll
            for (int k = 0; k < 8; ++k) pc[k] = qc[k] = 0.0f;
#pragma unroll
            for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int half = e >> 1, k = e & 1, c = 2 * n8 + k;
                    const int li = 16 * w + lg + 8 * half;
                    const int lj = jh + n8 * 8 + 2 * lt + k;
                    const int i = i0 + li, j = j0 + lj;
                    const float cbv = k ? cb2[n8][half].y : cb2[n8][half].x;
                    // masked before exp: exp(0) where masked, every product
                    // then selected to exactly 0
                    const bool in = i < Q && j <= i;
                    const float el = expf(in ? __fsub_rn(ci[half], cj[c]) : 0.0f);
                    const float ds_ = acc[4 * n8 + e];
                    const float cbl = __fmul_rn(cbv, el);
                    const float t1 = __fmul_rn(ds_, dj[c]);
                    const float s = in ? __fmul_rn(cbl, dj[c]) : 0.0f;
                    const float p = in ? __fmul_rn(__fmul_rn(t1, cbv), el)
                                       : 0.0f;
                    const float q = in ? __fmul_rn(ds_, cbl) : 0.0f;
                    pc[c] = __fadd_rn(pc[c], p);
                    qc[c] = __fadd_rn(qc[c], q);
                    rowp[half] = __fadd_rn(rowp[half], p);
                    put1(sm + L::wp, L::PB_X, lj, li, s);    // S^T
                    // dS spent: dcb's term in its place
                    acc[4 * n8 + e] = in ? __fmul_rn(t1, el) : 0.0f;
                }
            // the group's dcb partial: its first head stores, the others
            // add, in head order
            const bool first = h == h0;
#pragma unroll
            for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const float a = acc[4 * n8 + 2 * half];
                    const float b = acc[4 * n8 + 2 * half + 1];
                    *reinterpret_cast<float2*>(
                        dcbp + static_cast<long long>(
                                   i0 + 16 * w + lg + 8 * half) * qp +
                        j0 + jh + n8 * 8 + 2 * lt) = make_float2(
                        first ? a : __fadd_rn(prev[n8][half].x, a),
                        first ? b : __fadd_rn(prev[n8][half].y, b));
                }
            // P's row sums over the warpgroup's 32 columns: the lane's 8,
            // then its quad's
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                rowp[half] += __shfl_xor_sync(0xffffffffu, rowp[half], 1);
                rowp[half] += __shfl_xor_sync(0xffffffffu, rowp[half], 2);
                if (lt == 0) rowred[wg * kT + 16 * w + lg + 8 * half] =
                                 rowp[half];
            }
            // the column sums over the warp's rows, added to its partials
            {
                float* cp = colred + w * kT + jh + scatter_col();
                cp[0] = __fadd_rn(cp[0], reduce_scatter8(pc));
                cp[4 * kT] = __fadd_rn(cp[4 * kT], reduce_scatter8(qc));
            }
            fence_async_smem();
            __syncthreads();             // S^T's planes and row sums
            if (tid < kT && i0 + tid < Q)
                wk.rowp[((static_cast<long long>(bc) * nh + h) * nt + jt) *
                        qp + i0 + tid] = __fadd_rn(rowred[tid],
                                                   rowred[kT + tid]);
            // dx^T += dy_i^T S, the warpgroup's columns: A dy_i's planes
            // read transposed; its wait after the next tile's reads and
            // landing
            FragA a4[8];
#pragma unroll
            for (int k = 0; k < 8; ++k)
                a4[k] = load_a_plane_t(sm + L::yp, L::PB_X, 16 * w, 8 * k);
            fence_regs(dxa);
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                const uint64_t db4 = pdesc(wp, jh, k);
                const uint64_t ds4 = db4 + static_cast<uint64_t>(L::PB_X >> 4);
                wgmma_rs(dxa, a4[k].small, db4);
                wgmma_rs(dxa, a4[k].big, ds4);
                wgmma_rs(dxa, a4[k].big, db4);
            }
            wgmma_commit();
            if (it + 1 < nt) {
                prefetch(i0 + kT);
                land(bar_l, ph_l);
            }
            wgmma_wait_all();
            fence_regs(dxa);
#pragma unroll
            for (int k = 0; k < 8; ++k) fence_frag(a4[k]);
            __syncthreads();             // dy_i's and S^T's planes read
        }

        // dx of the head's column tile: dxa holds dx^T (rows p)
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int p = 16 * w + lg + 8 * (e >> 1);
                const int j = j0 + jh + n8 * 8 + 2 * lt + (e & 1);
                if (j < Q) dx[((row0 + j) * nh + h) * HD + p] = dxa[4 * n8 + e];
            }
        if (tid < 32) {
            // the tile's 64 columns, two a lane: the 4 warps' partials in
            // order, d_j, then the tile's sum of d in a fixed order
            float dsum = 0.0f;
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                const int c = lane + 32 * k;
                const int j = j0 + c;
                float p = colred[c], d = colred[4 * kT + c], dw = dwred[c];
#pragma unroll
                for (int r = 1; r < 4; ++r) {
                    p = __fadd_rn(p, colred[r * kT + c]);
                    d = __fadd_rn(d, colred[4 * kT + r * kT + c]);
                    dw = __fadd_rn(dw, dwred[r * kT + c]);
                }
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

    // the group's dB partial: db holds dB^T (rows n), the warpgroup's
    // columns
    float* out = wk.dbs + (static_cast<long long>(bc) * ng + g) * qp * N;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int n = 64 * mt + 16 * w + lg + 8 * (e >> 1);
                const int j = j0 + jh + n8 * 8 + 2 * lt + (e & 1);
                out[static_cast<long long>(j) * N + n] = db[mt][4 * n8 + e];
            }
}

// ---------------------------------------------------------------------------
// pass 3: per (chunk, 64-row tile t, dC or dB, column block): dC_t =
// dcb_t. B, or dB_t = dcb_.t^T C plus the groups' partials; then a block
// per head finishes
// ---------------------------------------------------------------------------

// columns a block of pass 3: half of N at N >= 64, so that the training
// shapes' grids are no smaller than the card's slots for them
template <int N>
constexpr int kChunkCols = N >= 64 ? N / 2 : N;

template <int N>
__host__ __device__ constexpr int p4_smem_floats() {
    return imax(kT * (kT + 8) + kT * (kChunkCols<N> + 8),
                kWarps * kMaxQ + 2 * kWarps);
}

// the dcb tile at rows r0.., columns c0.., the groups' partials (`plane`
// floats apart) summed in group order, into s[r * ld + c]; each group's
// loads issued together
__device__ __forceinline__ void dcb_tile(float* s, int ld,
                                         const float* __restrict__ part,
                                         long long plane, int ng, int qp,
                                         int r0, int c0) {
    constexpr int PER = kT * kT / 4 / kThreads;     // float4s a thread
    const float* p[PER];
    float4 sum[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const int e = threadIdx.x + k * kThreads;
        const int r = e / (kT / 4), c = (e % (kT / 4)) * 4;
        p[k] = part + static_cast<long long>(r0 + r) * qp + c0 + c;
        sum[k] = *reinterpret_cast<const float4*>(p[k]);
    }
#pragma unroll 2
    for (int gg = 1; gg < ng; ++gg) {
        float4 v[PER];
#pragma unroll
        for (int k = 0; k < PER; ++k)
            v[k] = *reinterpret_cast<const float4*>(p[k] + gg * plane);
#pragma unroll
        for (int k = 0; k < PER; ++k) {
            sum[k].x = __fadd_rn(sum[k].x, v[k].x);
            sum[k].y = __fadd_rn(sum[k].y, v[k].y);
            sum[k].z = __fadd_rn(sum[k].z, v[k].z);
            sum[k].w = __fadd_rn(sum[k].w, v[k].w);
        }
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const int e = threadIdx.x + k * kThreads;
        const int r = e / (kT / 4), c = (e % (kT / 4)) * 4;
        *reinterpret_cast<float4*>(s + r * ld + c) = sum[k];
    }
}

// head h, a warp a chunk: dcum assembled into shared memory, da its
// reverse cumsum in double (the lanes over runs of rows, a suffix scan
// across them), ddt += da A, dA = sum of da dt over chunks and rows in a
// fixed order
__device__ __forceinline__ void finish_head(const float* __restrict__ dt,
                                            const float* __restrict__ A,
                                            const float* __restrict__ dcum_in,
                                            float* __restrict__ ddt,
                                            float* __restrict__ dA, Work wk,
                                            int BC, int Q, int nh, int h,
                                            float* smem) {
    float (*dc)[kMaxQ] = reinterpret_cast<float (*)[kMaxQ]>(smem);
    double* part = reinterpret_cast<double*>(smem + kWarps * kMaxQ);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nt = cdiv(Q, kT), qp = nt * kT;
    const int per = cdiv(Q, 32);         // rows a lane in the scan
    const int r0 = min(lane * per, Q), r1 = min(r0 + per, Q);
    const float a_h = A[h];
    float* v = dc[warp];
    double total = 0.0;
    constexpr int RM = kMaxQ / 32;       // rows a lane: lane + 32 m
    constexpr int KT = kMaxQ / kT;       // column tiles at most
    for (int bc = warp; bc < BC; bc += kWarps) {
        const long long hb = static_cast<long long>(bc) * nh + h;
        const long long row0 = static_cast<long long>(bc) * Q;
        // every load of the lane's rows issued before any sum (entries
        // past a row's tiles, or past Q, read and never used)
        float din[RM], cl[RM], rp[RM][KT], de[KT];
#pragma unroll
        for (int k = 0; k < KT; ++k)
            de[k] = k < nt ? wk.dend[hb * nt + k] : 0.0f;
#pragma unroll
        for (int m = 0; m < RM; ++m) {
            const int i = min(lane + 32 * m, Q - 1);
            din[m] = dcum_in[(row0 + i) * nh + h];
            cl[m] = wk.col[hb * qp + i];
#pragma unroll
            for (int k = 0; k < KT; ++k)
                rp[m][k] = wk.rowp[(hb * nt + min(k, nt - 1)) * qp + i];
        }
        float dend = 0.0f;
#pragma unroll
        for (int k = 0; k < KT; ++k)
            if (k < nt) dend = __fadd_rn(dend, de[k]);
#pragma unroll
        for (int m = 0; m < RM; ++m) {
            const int i = lane + 32 * m;
            if (i < Q) {
                float d = din[m];
#pragma unroll
                for (int k = 0; k < KT; ++k)
                    if (k <= i / kT) d = __fadd_rn(d, rp[m][k]);
                d = __fadd_rn(d, cl[m]);
                if (i == Q - 1) d = __fadd_rn(d, dend);
                v[i] = d;
            }
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
        float dq[RM], tq[RM];
#pragma unroll
        for (int m = 0; m < RM; ++m) {
            const long long at = (row0 + min(lane + 32 * m, Q - 1)) * nh + h;
            dq[m] = ddt[at];
            tq[m] = dt[at];
        }
#pragma unroll
        for (int m = 0; m < RM; ++m) {
            const int i = lane + 32 * m;
            if (i < Q) {
                ddt[(row0 + i) * nh + h] = __fadd_rn(dq[m], __fmul_rn(v[i], a_h));
                total += static_cast<double>(__fmul_rn(v[i], tq[m]));
            }
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

template <int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_intra_bwd_chunk(const float* __restrict__ Bm,
                    const float* __restrict__ Cm,
                    const float* __restrict__ dt, const float* __restrict__ A,
                    const float* __restrict__ dcum_in, float* __restrict__ dB,
                    float* __restrict__ dC, float* __restrict__ ddt,
                    float* __restrict__ dA, Work wk, int BC, int Q, int nh) {
    extern __shared__ __align__(16) float smem[];
    constexpr int NB = kChunkCols<N>;    // the block's columns
    constexpr int NS = N / NB;
    constexpr int LDA = kT + 4;          // dcb rows (row-major reads)
    constexpr int LDT = kT + 8;          // dcb read transposed
    constexpr int LDN = NB + 8;          // B and C (k-major reads)
    constexpr int NTB = NB / 16;
    const int nt = cdiv(Q, kT), qp = nt * kT, ng = wk.ng;
    const long long tiles = 2LL * BC * nt * NS;
    if (blockIdx.x >= tiles) {
        finish_head(dt, A, dcum_in, ddt, dA, wk, BC, Q, nh,
                    static_cast<int>(blockIdx.x - tiles), smem);
        return;
    }
    const int n0 = static_cast<int>(blockIdx.x % NS) * NB;
    const int b = static_cast<int>(blockIdx.x / NS);
    const int bc = b / (2 * nt), t = (b / 2) % nt;
    const bool is_dc = (b & 1) == 0;
    const int t0 = t * kT;
    const int tid = threadIdx.x, warp = tid >> 5;
    const int rs = warp & 3, ch = warp >> 2;
    const int lg = lane_g(), lt = lane_t();
    const long long row0 = static_cast<long long>(bc) * Q;
    float* As = smem;
    float* Ns = smem + kT * LDT;
    const long long plane = static_cast<long long>(qp) * qp;
    const float* part = wk.dcbp + static_cast<long long>(bc) * ng * plane;

    float acc[NTB][4];
    zero(acc);
    if (is_dc) {
        // dC rows t: sum over column tiles kt <= t of dcb[t][kt] B[kt]
        for (int kt = 0; kt <= t; ++kt) {
            copy_tile<kT, NB>(Ns, LDN, Q - kt * kT, [&](int r, int c) {
                return Bm + (row0 + kt * kT + r) * N + n0 + c; });
            cp_async_commit();
            dcb_tile(As, LDA, part, plane, ng, qp, t0, kt * kT);
            cp_async_wait_all();
            __syncthreads();
#pragma unroll 4
            for (int kk = 0; kk < kT; kk += 8) {
                const FragA fa = load_a(As, LDA, rs * 16, kk);
#pragma unroll
                for (int n8 = 0; n8 < NTB; ++n8)
                    mma_3x(acc[n8], fa,
                           load_b_kn(Ns, LDN, kk, ch * (NB / 2) + n8 * 8));
            }
            __syncthreads();
        }
#pragma unroll
        for (int n8 = 0; n8 < NTB; ++n8) {
            const int c = n0 + ch * (NB / 2) + n8 * 8 + 2 * lt;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int i = t0 + rs * 16 + lg + 8 * half;
                if (i < Q)
                    *reinterpret_cast<float2*>(dC + (row0 + i) * N + c) =
                        make_float2(acc[n8][2 * half], acc[n8][2 * half + 1]);
            }
        }
        return;
    }

    // dB rows t: sum over row tiles kt >= t of dcb[kt][t]^T C[kt], plus
    // the sum over groups of their partials, in order
    for (int kt = t; kt < nt; ++kt) {
        copy_tile<kT, NB>(Ns, LDN, Q - kt * kT, [&](int r, int c) {
            return Cm + (row0 + kt * kT + r) * N + n0 + c; });
        cp_async_commit();
        dcb_tile(As, LDT, part, plane, ng, qp, kt * kT, t0);
        cp_async_wait_all();
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < kT; kk += 8) {
            if (kt * kT + kk >= Q) break;
            const FragA fa = load_a_t(As, LDT, rs * 16, kk);
#pragma unroll
            for (int n8 = 0; n8 < NTB; ++n8)
                mma_3x(acc[n8], fa,
                       load_b_kn(Ns, LDN, kk, ch * (NB / 2) + n8 * 8));
        }
        __syncthreads();
    }
    const float* dbs = wk.dbs + static_cast<long long>(bc) * ng * qp * N;
#pragma unroll
    for (int n8 = 0; n8 < NTB; ++n8) {
        const int c = n0 + ch * (NB / 2) + n8 * 8 + 2 * lt;
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
// launch
// ---------------------------------------------------------------------------

template <typename K>
int allow_smem(K kernel, int bytes) {
    // once per instantiation: the largest shared memory its launches use
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    return static_cast<int>(e);
}

// the training widths take pass 2's wgmma form
template <int HD, int N>
constexpr bool kWgForm = HD == 64 && (N == 64 || N == 128);

template <int HD, int N>
int launch(const float* x, const float* dt, const float* A, const float* B,
           const float* C, const float* dy, const float* dst,
           const float* dcum, float* dx, float* ddt, float* dA, float* dB,
           float* dC, float* work, int BC, int Q, int nh, cudaStream_t st) {
    static_assert(HD % 16 == 0 && N % 16 == 0, "tile shape");
    constexpr int b1 = 4 * prep_smem_floats<N>();
    constexpr int b3 = 4 * p4_smem_floats<N>();
    int b2;
    if constexpr (kWgForm<HD, N>) b2 = WgL<HD, N>::bytes;
    else b2 = 4 * P3<HD, N>::floats;
    static bool attr_set = false;
    static int prep_slots = 0;           // blocks of pass 1 the card holds
    if (!attr_set) {
        int rc = allow_smem(ssd_intra_bwd_prep<N>, b1);
        int dev = 0, sms = 0, per = 0;
        if (rc == 0) rc = static_cast<int>(cudaGetDevice(&dev));
        if (rc == 0)
            rc = static_cast<int>(cudaDeviceGetAttribute(
                &sms, cudaDevAttrMultiProcessorCount, dev));
        if (rc == 0)
            rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per, ssd_intra_bwd_prep<N>, kThreads, b1));
        prep_slots = imax(1, sms * per);
        if (rc == 0) {
            if constexpr (kWgForm<HD, N>)
                rc = allow_smem(ssd_intra_bwd_heads_wg<HD, N>, b2);
            else
                rc = allow_smem(ssd_intra_bwd_heads<HD, N>, b2);
        }
        if (rc == 0) rc = allow_smem(ssd_intra_bwd_chunk<N>, b3);
        if (rc != 0) return rc;
        attr_set = true;
    }
    Work wk;
    work_floats(BC, Q, nh, N, &wk, work);
    wk.ng = cdiv(nh, kWgForm<HD, N> ? kHGW : kHG);
    const long long nt = cdiv(Q, kT), ng = wk.ng;
    const long long blocks[3] = {prep_slots, nt * BC * ng,
                                 2 * BC * nt * (N / kChunkCols<N>) + nh};
    for (long long b : blocks)
        if (b > 0x7fffffffLL) return -4;
    ssd_intra_bwd_prep<N><<<static_cast<unsigned>(blocks[0]), kThreads, b1,
                            st>>>(dt, A, B, C, wk, BC, Q, nh);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    if constexpr (kWgForm<HD, N>)
        ssd_intra_bwd_heads_wg<HD, N><<<static_cast<unsigned>(blocks[1]),
                                        2 * kWgThreads, b2, st>>>(
            x, dt, B, dy, dst, dx, ddt, wk, BC, Q, nh);
    else
        ssd_intra_bwd_heads<HD, N><<<static_cast<unsigned>(blocks[1]),
                                     kThreads, b2, st>>>(
            x, dt, B, dy, dst, dx, ddt, wk, BC, Q, nh);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ssd_intra_bwd_chunk<N><<<static_cast<unsigned>(blocks[2]), kThreads, b3,
                             st>>>(B, C, dt, A, dcum, dB, dC, ddt, dA, wk, BC,
                                   Q, nh);
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
