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
// some 178 MB in and out, about 50 operations per byte, above the
// float32 ridge (20). Design (simple, float32 on the CUDA cores, no
// tensor cores yet). The TPU grid of (Bt, nc) is 32 programs at that
// shape, too few for 132 SMs, and a (Q, Q) float32 score matrix per head
// is 256 KiB, more than a block's shared memory; so the grid has two
// kinds of blocks of 256 threads, one launch:
//  - y blocks, one per (chunk, 64-row tile, group of 8 heads), heaviest
//    row tiles first: C B^T for the tile's 64 rows and the columns up to
//    its diagonal is built once in shared memory (64 x (Q+1) floats, in
//    steps of 32 columns x 32 state dims) and reused by the group's 8
//    heads; per head, 32-column tiles of the masked scores and of x
//    stream through shared memory and each thread keeps 4 rows x hd/16
//    columns of y in registers;
//  - state blocks, one per (chunk, head), which also write cum: the
//    decay-weighted B (32 rows x N) and x (32 rows x hd) stream through
//    shared memory and each thread keeps hd*N/256 state entries.
// At Q 256, hd 64 a y block takes 99 KB of dynamic shared memory (set
// with cudaFuncSetAttribute), two blocks per SM. The next designs move
// the products to wgmma.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTI = 64;          // y rows per block
constexpr int kTJ = 32;          // columns per score / x / B tile
constexpr int kHG = 8;           // heads per y block
constexpr int kMaxQ = 256;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int tn_of(int n) { return n < 32 ? n : 32; }

template <int HD, int N>
__host__ __device__ constexpr int y_smem_floats(int q) {
    return kTI * (q + 1) + 2 * kHG * q +
           (kTI * (tn_of(N) + 1) + kTJ * (tn_of(N) + 1) >
                    kTJ * HD + kTI * (kTJ + 1)
                ? kTI * (tn_of(N) + 1) + kTJ * (tn_of(N) + 1)
                : kTJ * HD + kTI * (kTJ + 1));
}

template <int HD, int N>
__host__ __device__ constexpr int s_smem_floats(int q) {
    return 2 * q + kTJ * HD + kTJ * N;
}

// cum of head h over rows 0..len-1 from dt (already in dts), sequential
// in double from float products, rounded once per row
__device__ __forceinline__ void scan_cum(const float* dts, float a_h,
                                         float* cums, int len) {
    double c = 0.0;
    for (int j = 0; j < len; ++j) {
        c += static_cast<double>(__fmul_rn(dts[j], a_h));
        cums[j] = static_cast<float>(c);
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
    constexpr int NC = HD / 16;          // y columns per thread
    const int tid = threadIdx.x;
    const int QP = Q + 1;
    float* cbS = smem;                   // kTI x QP: C_i . B_j
    float* cumS = cbS + kTI * QP;        // kHG x Q
    float* dtS = cumS + kHG * Q;         // kHG x Q
    float* work = dtS + kHG * Q;
    const int i0 = it * kTI;
    const int jmax = min(i0 + kTI, Q);   // columns the tile's rows reach
    const int h0 = g * kHG;
    const int nhg = min(kHG, nh - h0);
    const long long row0 = static_cast<long long>(bc) * Q;

    for (int e = tid; e < nhg * jmax; e += kThreads) {
        const int j = e / nhg, hh = e % nhg;
        dtS[hh * Q + j] = dt[(row0 + j) * nh + h0 + hh];
    }
    __syncthreads();
    if (tid < nhg) scan_cum(dtS + tid * Q, A[h0 + tid], cumS + tid * Q, jmax);

    // C B^T for rows i0.., columns 0..jmax-1
    {
        float* Cs = work;                    // kTI x (TN+1)
        float* Bs = Cs + kTI * (TN + 1);     // kTJ x (TN+1)
        const int rb = tid / kTJ, c = tid % kTJ;
        for (int j0 = 0; j0 < jmax; j0 += kTJ) {
            float acc[kTI / 8];
#pragma unroll
            for (int a = 0; a < kTI / 8; ++a) acc[a] = 0.0f;
            for (int n0 = 0; n0 < N; n0 += TN) {
                __syncthreads();
                for (int e = tid; e < kTI * TN; e += kThreads) {
                    const int r = e / TN, k = e % TN;
                    const int i = i0 + r;
                    Cs[r * (TN + 1) + k] =
                        i < Q ? Cm[(row0 + i) * N + n0 + k] : 0.0f;
                }
                for (int e = tid; e < kTJ * TN; e += kThreads) {
                    const int r = e / TN, k = e % TN;
                    const int j = j0 + r;
                    Bs[r * (TN + 1) + k] =
                        j < Q ? Bm[(row0 + j) * N + n0 + k] : 0.0f;
                }
                __syncthreads();
#pragma unroll 8
                for (int k = 0; k < TN; ++k) {
                    const float bv = Bs[c * (TN + 1) + k];
#pragma unroll
                    for (int a = 0; a < kTI / 8; ++a)
                        acc[a] = fmaf(Cs[(rb + 8 * a) * (TN + 1) + k], bv,
                                      acc[a]);
                }
            }
            if (j0 + c < jmax) {
#pragma unroll
                for (int a = 0; a < kTI / 8; ++a)
                    cbS[(rb + 8 * a) * QP + j0 + c] = acc[a];
            }
        }
    }

    // per head: y = (cb * L * dt) x over 32-column tiles
    float* Xs = work;                    // kTJ x HD
    float* Ps = Xs + kTJ * HD;           // kTI x (kTJ+1)
    const int ty = tid / 16, tx = tid % 16;
    for (int hh = 0; hh < nhg; ++hh) {
        const int h = h0 + hh;
        const float* cumh = cumS + hh * Q;
        const float* dth = dtS + hh * Q;
        float acc[4][NC];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int cc = 0; cc < NC; ++cc) acc[k][cc] = 0.0f;
        for (int j0 = 0; j0 < jmax; j0 += kTJ) {
            __syncthreads();             // cb, cum built; last tile read
            for (int e = tid; e < kTJ * HD; e += kThreads) {
                const int jj = e / HD, p = e % HD;
                const int j = j0 + jj;
                Xs[e] = j < Q ? x[((row0 + j) * nh + h) * HD + p] : 0.0f;
            }
            for (int e = tid; e < kTI * kTJ; e += kThreads) {
                const int r = e / kTJ, jj = e % kTJ;
                const int i = i0 + r, j = j0 + jj;
                float v = 0.0f;
                if (j <= i && i < Q)     // masked before exp
                    v = __fmul_rn(__fmul_rn(cbS[r * QP + j],
                                            expf(__fsub_rn(cumh[i], cumh[j]))),
                                  dth[j]);
                Ps[r * (kTJ + 1) + jj] = v;
            }
            __syncthreads();
#pragma unroll 4
            for (int jj = 0; jj < kTJ; ++jj) {
                float pv[4], xv[NC];
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    pv[k] = Ps[(ty * 4 + k) * (kTJ + 1) + jj];
#pragma unroll
                for (int cc = 0; cc < NC; ++cc)
                    xv[cc] = Xs[jj * HD + tx + 16 * cc];
#pragma unroll
                for (int k = 0; k < 4; ++k)
#pragma unroll
                    for (int cc = 0; cc < NC; ++cc)
                        acc[k][cc] = fmaf(pv[k], xv[cc], acc[k][cc]);
            }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int i = i0 + ty * 4 + k;
            if (i < Q) {
#pragma unroll
                for (int cc = 0; cc < NC; ++cc)
                    y[((row0 + i) * nh + h) * HD + tx + 16 * cc] = acc[k][cc];
            }
        }
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
    constexpr int K = HD * N / kThreads;     // state entries per thread
    constexpr int PS = kThreads / N;         // p stride between them
    const int tid = threadIdx.x;
    float* cumS = smem;                      // Q
    float* wS = cumS + Q;                    // Q: dt, then the weight
    float* Xs = wS + Q;                      // kTJ x HD
    float* Bw = Xs + kTJ * HD;               // kTJ x N
    const long long row0 = static_cast<long long>(bc) * Q;

    for (int j = tid; j < Q; j += kThreads) wS[j] = dt[(row0 + j) * nh + h];
    __syncthreads();
    if (tid == 0) scan_cum(wS, A[h], cumS, Q);
    __syncthreads();
    const float cend = cumS[Q - 1];
    for (int j = tid; j < Q; j += kThreads) {
        cum[(row0 + j) * nh + h] = cumS[j];
        wS[j] = __fmul_rn(expf(__fsub_rn(cend, cumS[j])), wS[j]);
    }

    const int n = tid % N, p0 = tid / N;
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.0f;
    for (int j0 = 0; j0 < Q; j0 += kTJ) {
        __syncthreads();                     // weights ready; last tile read
        for (int e = tid; e < kTJ * HD; e += kThreads) {
            const int jj = e / HD, p = e % HD;
            const int j = j0 + jj;
            Xs[e] = j < Q ? x[((row0 + j) * nh + h) * HD + p] : 0.0f;
        }
        for (int e = tid; e < kTJ * N; e += kThreads) {
            const int jj = e / N, nn = e % N;
            const int j = j0 + jj;
            Bw[e] = j < Q ? __fmul_rn(Bm[(row0 + j) * N + nn], wS[j]) : 0.0f;
        }
        __syncthreads();
#pragma unroll 4
        for (int jj = 0; jj < kTJ; ++jj) {
            const float bv = Bw[jj * N + n];
#pragma unroll
            for (int k = 0; k < K; ++k)
                acc[k] = fmaf(Xs[jj * HD + p0 + PS * k], bv, acc[k]);
        }
    }
    const long long base = (static_cast<long long>(bc) * nh + h) * HD;
#pragma unroll
    for (int k = 0; k < K; ++k)
        states[(base + p0 + PS * k) * N + n] = acc[k];
}

template <int HD, int N>
__global__ void __launch_bounds__(kThreads)
ssd_intra_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ states, float* __restrict__ cum, int BC,
                 int Q, int nh) {
    extern __shared__ float smem[];
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
    static_assert(HD % 16 == 0 && (HD * N) % kThreads == 0 &&
                      kThreads % N == 0,
                  "tile shape");
    auto kernel = ssd_intra_kernel<HD, N>;
    constexpr int max_floats = y_smem_floats<HD, N>(kMaxQ) >
                                       s_smem_floats<HD, N>(kMaxQ)
                                   ? y_smem_floats<HD, N>(kMaxQ)
                                   : s_smem_floats<HD, N>(kMaxQ);
    static bool attr_set = false;            // once per instantiation
    if (!attr_set) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(sizeof(float) * max_floats));
        if (e != cudaSuccess) return static_cast<int>(e);
        attr_set = true;
    }
    const int yf = y_smem_floats<HD, N>(Q), sf = s_smem_floats<HD, N>(Q);
    const size_t smem = sizeof(float) * static_cast<size_t>(yf > sf ? yf : sf);
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
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (hd) {
        case 16: return dispatch_n<16>(n, x, dt, A, B, C, y, states, cum, BC, Q, nh, st);
        case 32: return dispatch_n<32>(n, x, dt, A, B, C, y, states, cum, BC, Q, nh, st);
        case 64: return dispatch_n<64>(n, x, dt, A, B, C, y, states, cum, BC, Q, nh, st);
        case 128: return dispatch_n<128>(n, x, dt, A, B, C, y, states, cum, BC, Q, nh, st);
        default: return -2;
    }
}
