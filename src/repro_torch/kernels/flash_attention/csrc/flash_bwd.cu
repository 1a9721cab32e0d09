// Causal GQA flash-attention backward for sm_90a: the gradient of the
// prefill's self-attention (positions 0..S-1), recomputed from the
// forward's saved out and lse.
//
// Replaces no Pallas kernel: the reference differentiates its
// `custom_vjp` `_flash` with the jnp `_flash_bwd`
// (src/repro/models/attention.py:180), which XLA fuses into loops on the
// TPU. Same function: q (B, S, H, hd), k and v (B, S, Hkv, hd), bf16;
// out (B, H, S, hd), lse (B, H, S) and dout (B, H, S, hd) float32 (dout
// may be any strided view whose rows are contiguous); scale the scores'
// scale:
//   delta = sum_d dout * out                       (per query row)
//   P     = exp(scale * q.k - lse),  masked to key <= query < S
//   dP    = dout . v,  dS = P * (dP - delta)
//   dv    = sum_g P^T dout,  dk = scale * sum_g dS^T q,  dq = scale * dS k
// dq, dk and dv in bf16, dk and dv reduced over the GQA group. dk is
// taken against q and scaled once at the end, which is the reference's
// product against the scaled q up to float32 rounding; dq likewise.
//
// Bound on this card: operations. The five products (scores, dP, dV, dK,
// dQ) over the causal half are 5 * 2 * B*H*S^2/2 * hd operations against
// q, k, v, out, dout, lse in and dq, dk, dv out: at gemma-2b's training
// shape (B 2, S 2048, H 8, Hkv 1, hd 256) 85.9 GFLOP, 0.0869 ms at the
// bf16 tensor-core rate.
//
// Design:
// - Two passes and no float atomics, so that two runs give the same
//   bits: a dK/dV pass, one block per (kv tile of 64 keys, head, batch),
//   walks the query tiles on and after its diagonal, recomputes S^T and
//   dP^T and accumulates dV and dK in registers; a dQ pass, one block per
//   (64 query rows, head, batch), walks the kv tiles up to its diagonal
//   and accumulates dQ. A prologue kernel computes delta and writes dout
//   as its bf16 terms (below); an epilogue sums the dK/dV pass's float32
//   per-head partials over the group in a fixed order (512 dK/dV blocks
//   at gemma's shape instead of the 64 that one block a KV head would
//   give on 132 SMs). Both passes launch the heaviest tiles first.
// - Every product runs on the tensor cores: mma.sync m16n8k16 bf16 with
//   float32 accumulators, both operands read from shared memory by
//   ldmatrix. 8 warps a block: warp w owns rows 16 (w % 4) .. of a
//   product's 64-row output and half of its columns (w / 4); at hd 256 a
//   thread holds 64 float32 of dV and 64 of dK.
// - q, k and v are bf16 and enter the products as they are. The float32
//   operands (P, dS and dout) enter as `terms` bf16 terms (t1 = bf16(x),
//   t2 = bf16(x - t1), t3 = bf16(x - t1 - t2), each difference exact in
//   float32; three sum to x exactly), as flash_fwd.cu splits P; a product
//   of two split operands keeps the term pairs (i, j) with i + j < terms.
//   When no value of dout has a low term (dout is bf16-exact when the
//   model runs in bf16: the prologue raises a flag otherwise), only its
//   first term is read and multiplied.
// - P and dS pass through shared memory as their terms; the causal mask
//   zeroes P before dS and before either product.
// - Every tile comes from device memory by 16-byte cp.async copies into
//   one of two stages: the next step's tiles are in flight while this
//   step computes (the first form loaded dout's float32 rows into
//   registers, one round trip at a time, and ran at 2 ms a launch at
//   gemma's shape whether P and dS had one term or three). Rows of hd >=
//   64 are stored unpadded with their 16-byte pieces swizzled (piece c of
//   row r at c ^ (r % 8)), narrower rows padded by 16 bytes: ldmatrix
//   reads are free of bank conflicts either way.
// - Shared memory at hd 256: the dK/dV pass 222.5 KiB (K and V 64 x 256;
//   two stages of a 32-row q tile, dout's three terms, lse and delta;
//   P^T and dS^T in three terms each), the dQ pass 207.5 KiB (64 query
//   rows and dout's terms; two stages of 32-key K and V tiles; dS's
//   terms); narrower widths take 64-row tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int kThreads = 256;      // 8 warps
constexpr int kTerms = 3;          // the most bf16 terms of an operand
constexpr float kLog2e = 1.4426950408889634f;

// elements of a row of a width-HD tile in shared memory
template <int HD>
constexpr int row_elems() { return HD >= 64 ? HD : HD + 8; }

// element offset of (row r, column c) in a width-HD tile: the 16-byte
// pieces of a row swizzled at hd >= 64, rows padded below
template <int HD>
struct Wide {
    __device__ __forceinline__ int operator()(int r, int c) const {
        if constexpr (HD >= 64)
            return r * HD + ((((c >> 3) ^ (r & 7)) << 3) | (c & 7));
        else
            return r * (HD + 8) + c;
    }
};

// a padded tile of `ld` elements a row (P^T, dS^T, dS)
struct Padded {
    int ld;
    __device__ __forceinline__ int operator()(int r, int c) const {
        return r * ld + c;
    }
};

template <int HD>
struct Tile {
    static constexpr int RW = row_elems<HD>();
    // dK/dV pass: BC keys a block, BR query rows a step
    static constexpr int BC = 64;
    static constexpr int BR = HD == 256 ? 32 : 64;
    static constexpr int PLD = BR + 8;
    // a stage: q (BR rows), dout's terms (BR rows each), lse and delta
    static constexpr int KV_STAGE = 2 * (BR * RW + kTerms * BR * RW) + 8 * BR;
    static constexpr int KV_SMEM =
        2 * 2 * BC * RW + 2 * KV_STAGE + 2 * 2 * kTerms * BC * PLD;
    // dQ pass: QR query rows a block, QC keys a step
    static constexpr int QR = 64;
    static constexpr int QC = HD == 256 ? 32 : 64;
    static constexpr int SLD = QC + 8;
    static constexpr int DQ_STAGE = 2 * 2 * QC * RW;          // K, then V
    static constexpr int DQ_SMEM = 2 * (QR * RW + kTerms * QR * RW)
                                   + 8 * QR + 2 * DQ_STAGE
                                   + 2 * kTerms * QR * SLD;
    static_assert(KV_SMEM <= 232448 && DQ_SMEM <= 232448,
                  "a block's shared memory exceeds the card's 227 KiB");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ void ldsm2(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

__device__ __forceinline__ void ldsm2t(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 "
                 "{%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// d (16 x 8, float32) += a (16 x 16, bf16) * b (16 x 8, bf16)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp: acc (16 x 8 NT, float32) += A (16 x K) * B (K x 8 NT), each
// operand the sum of its bf16 terms in shared memory (na and nb of them,
// tiles at a[] and b[]), the term pairs (t, u) with t + u < limit. A(r,
// k) is at a + 2 la(a0 + r, k). B(k, n) is at b + 2 lb(b0 + n, k) (stored
// [n][k]), or with KN at b + 2 lb(k, b0 + n) ([k][n], read through
// ldmatrix's transpose). K is a multiple of 16; a0 and b0 of 8.
template <int NT, int K, bool KN, class LA, class LB>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4],
                                          const uint32_t (&a)[kTerms], int na,
                                          LA la, int a0,
                                          const uint32_t (&b)[kTerms], int nb,
                                          LB lb, int b0, int limit, int lane) {
    // ldmatrix x4: lanes 8i .. 8i + 7 give the rows of matrix i
    const int ar = a0 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int ac = (lane >> 4) * 8;
    const int bn = b0 + (KN ? (lane >> 4) * 8 : (lane & 7) + (lane >> 4) * 8);
    const int bk = KN ? (lane & 7) + ((lane >> 3) & 1) * 8
                      : ((lane >> 3) & 1) * 8;
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 16) {
        uint32_t af[kTerms][4];
        const uint32_t aoff = 2u * la(ar, k0 + ac);
#pragma unroll
        for (int t = 0; t < kTerms; ++t)
            if (t < na) ldsm4(af[t], a[t] + aoff);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
            const uint32_t off = 2u * (KN ? lb(k0 + bk, 8 * j + bn)
                                          : lb(8 * j + bn, k0 + bk));
            uint32_t bf[kTerms][4];
#pragma unroll
            for (int u = 0; u < kTerms; ++u) {
                if (u >= nb) continue;
                if (j + 1 < NT) {
                    if (KN) ldsm4t(bf[u], b[u] + off);
                    else ldsm4(bf[u], b[u] + off);
                } else {
                    if (KN) ldsm2t(bf[u], b[u] + off);
                    else ldsm2(bf[u], b[u] + off);
                }
            }
#pragma unroll
            for (int t = 0; t < kTerms; ++t) {
#pragma unroll
                for (int u = 0; u < kTerms; ++u) {
                    if (t >= na || u >= nb || t + u >= limit) continue;
                    mma16816(acc[j], af[t], bf[u][0], bf[u][1]);
                    if (j + 1 < NT)
                        mma16816(acc[j + 1 < NT ? j + 1 : j], af[t], bf[u][2],
                                 bf[u][3]);
                }
            }
        }
    }
}

// x0, x1 (a pair of neighbours in a row) as `terms` bf16 terms, term t at
// dst + t * plane
__device__ __forceinline__ void split_store(bf16* dst, int plane, float x0,
                                            float x1, int terms) {
#pragma unroll
    for (int t = 0; t < kTerms; ++t) {
        if (t >= terms) break;
        const bf162 h = __floats2bfloat162_rn(x0, x1);
        *reinterpret_cast<bf162*>(dst + t * plane) = h;
        const float2 f = __bfloat1622float2(h);
        x0 -= f.x;     // exact in float32: h is x rounded to nearest
        x1 -= f.y;
    }
}

// rows r0 .. r0 + ROWS - 1 of a bf16 matrix whose row s starts at src + s
// * stride, into a width-HD tile at dst; rows past S are zeros
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int r0, int S,
                                          int tid) {
    constexpr int PIECES = HD / 8;                   // 16 bytes each
    const uint32_t base = smem_u32(dst);
    const Wide<HD> at;
#pragma unroll
    for (int i = tid; i < ROWS * PIECES; i += kThreads) {
        const int r = i / PIECES, c = (i % PIECES) * 8;
        const int s = r0 + r;
        cp_async16(base + 2u * at(r, c), src + (s < S ? s : S - 1) * stride
                   + c, s < S ? 16 : 0);
    }
}

// ROWS float32 values from src + r0 .. into dst, zeros past S
template <int ROWS>
__device__ __forceinline__ void load_row_f32(float* dst, const float* src,
                                             int r0, int S, int tid) {
    for (int i = tid; i < ROWS; i += kThreads) {
        const int s = r0 + i;
        cp_async4(smem_u32(dst + i), src + (s < S ? s : S - 1),
                  s < S ? 4 : 0);
    }
}

// the prologue: delta = sum_d dout * out, and dout's `terms` bf16 terms
// (terms, B, H, S, HD); *lo set when any value has a low term. One warp
// a (batch, head, row)
__global__ void __launch_bounds__(kThreads)
flash_bwd_prep(const float* __restrict__ out, const float* __restrict__ dout,
               long long sb, long long sh, long long ss,
               float* __restrict__ delta, bf16* __restrict__ dterms,
               int* __restrict__ lo, int H, int S, int HD, long long rows,
               int terms) {
    const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32)
                          + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;
    const int s = static_cast<int>(row % S);
    const int h = static_cast<int>((row / S) % H);
    const long long b = row / (static_cast<long long>(S) * H);
    const float* o = out + row * HD;
    const float* d = dout + b * sb + h * sh + s * ss;
    bf16* dt = dterms + row * HD;
    const long long plane = rows * HD;
    float acc = 0.f;
    bool low = false;
    for (int i = lane; i < HD; i += 32) {
        float x = d[i];
        acc += o[i] * x;
        for (int t = 0; t < terms; ++t) {
            const bf16 hv = __float2bfloat16_rn(x);
            dt[t * plane + i] = hv;
            x -= __bfloat162float(hv);          // exact in float32
            if (t == 0) low |= x != 0.f;
        }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, m);
    if (lane == 0) delta[row] = acc;
    if (__any_sync(0xffffffffu, low) && lane == 0) atomicOr(lo, 1);
}

// the dK/dV pass: float32 partials (B, S, H, HD) of dK / scale and dV,
// one block a (head, batch, kv tile), the kv tile the slowest grid axis
// (small tiles walk the most query rows, so they start first)
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ lse,
               const float* __restrict__ delta,
               const bf16* __restrict__ dterms, const int* __restrict__ lo,
               float* __restrict__ dk_part, float* __restrict__ dv_part,
               int S, int H, int hkv, float scale_log2, int terms) {
    using T = Tile<HD>;
    constexpr int BC = T::BC, BR = T::BR, RW = T::RW, PLD = T::PLD;
    constexpr int NTS = BR / 16;     // n8 tiles of a warp's S^T columns
    constexpr int NTD = HD / 16;     // n8 tiles of a warp's dV columns
    extern __shared__ __align__(128) uint8_t smem_raw[];
    bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
    bf16* Vs = Ks + BC * RW;
    uint8_t* stages = reinterpret_cast<uint8_t*>(Vs + BC * RW);
    bf16* Ps = reinterpret_cast<bf16*>(stages + 2 * T::KV_STAGE);
    bf16* Ds = Ps + kTerms * BC * PLD;
    // stage st: q, dout's terms, lse, delta
    auto q_of = [&](int st) {
        return reinterpret_cast<bf16*>(stages + st * T::KV_STAGE);
    };
    auto o_of = [&](int st) { return q_of(st) + BR * RW; };
    auto lse_of = [&](int st) {
        return reinterpret_cast<float*>(o_of(st) + kTerms * BR * RW);
    };

    const int h = blockIdx.x, b = blockIdx.y;
    const int kv0 = blockIdx.z * BC;
    const int kvh = h / (H / hkv);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wr = warp & 3, wc = warp >> 2;
    const int g = lane >> 2, tig = lane & 3;
    const long long head_row = (static_cast<long long>(b) * H + h) * S;
    const long long plane = static_cast<long long>(gridDim.y) * H * S * HD;
    const int n_o = *lo ? terms : 1;
    const Wide<HD> wide;
    const Padded pad{PLD};

    const bf16* qh = q + (static_cast<long long>(b) * S * H + h) * HD;
    const bf16* oh = dterms + head_row * HD;
    auto issue = [&](int st, int q0) {
        load_tile<HD, BR>(q_of(st), qh, static_cast<long long>(H) * HD, q0, S,
                          tid);
        for (int u = 0; u < n_o; ++u)
            load_tile<HD, BR>(o_of(st) + u * BR * RW, oh + u * plane, HD, q0,
                              S, tid);
        load_row_f32<BR>(lse_of(st), lse + head_row, q0, S, tid);
        load_row_f32<BR>(lse_of(st) + BR, delta + head_row, q0, S, tid);
        cp_async_commit();
    };

    const bf16* kh = k + (static_cast<long long>(b) * S * hkv + kvh) * HD;
    const bf16* vh = v + (static_cast<long long>(b) * S * hkv + kvh) * HD;
    load_tile<HD, BC>(Ks, kh, static_cast<long long>(hkv) * HD, kv0, S, tid);
    load_tile<HD, BC>(Vs, vh, static_cast<long long>(hkv) * HD, kv0, S, tid);
    const int qt0 = kv0 / BR, n_q = (S + BR - 1) / BR - qt0;
    issue(0, qt0 * BR);

    float adv[NTD][4], adk[NTD][4];
#pragma unroll
    for (int j = 0; j < NTD; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) adv[j][e] = adk[j][e] = 0.f;

    const uint32_t sK = smem_u32(Ks), sV = smem_u32(Vs);
    const uint32_t sP = smem_u32(Ps), sD = smem_u32(Ds);

    for (int it = 0; it < n_q; ++it) {
        const int st = it & 1, q0 = (qt0 + it) * BR;
        cp_async_wait_all();
        // this step's tiles are in; the last step's reads are done
        __syncthreads();
        if (it + 1 < n_q) issue(st ^ 1, q0 + BR);
        const uint32_t sQ = smem_u32(q_of(st)), sO = smem_u32(o_of(st));
        const float* lse2 = lse_of(st);
        const float* dl = lse2 + BR;

        // S^T and dP^T: the warp's 16 keys x BR/2 query rows
        float sc[NTS][4], dpt[NTS][4];
#pragma unroll
        for (int j = 0; j < NTS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[j][e] = dpt[j][e] = 0.f;
        {
            const uint32_t ak[kTerms] = {sK, 0, 0};
            const uint32_t bq[kTerms] = {sQ, 0, 0};
            warp_gemm<NTS, HD, false>(sc, ak, 1, wide, 16 * wr, bq, 1, wide,
                                      (BR / 2) * wc, 1, lane);
            const uint32_t av[kTerms] = {sV, 0, 0};
            uint32_t bo[kTerms];
#pragma unroll
            for (int u = 0; u < kTerms; ++u) bo[u] = sO + 2u * (u * BR * RW);
            warp_gemm<NTS, HD, false>(dpt, av, 1, wide, 16 * wr, bo, n_o,
                                      wide, (BR / 2) * wc, n_o, lane);
        }
        // P^T and dS^T into shared memory as their terms
#pragma unroll
        for (int j = 0; j < NTS; ++j) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int kl = 16 * wr + g + 8 * half, key = kv0 + kl;
                const int ql = (BR / 2) * wc + 8 * j + 2 * tig;
                float p[2], ds[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int row = q0 + ql + e;
                    const bool ok = key <= row && row < S;
                    p[e] = ok ? exp2f(fmaf(sc[j][2 * half + e], scale_log2,
                                           -lse2[ql + e] * kLog2e))
                              : 0.f;
                    ds[e] = p[e] * (dpt[j][2 * half + e] - dl[ql + e]);
                }
                split_store(Ps + kl * PLD + ql, BC * PLD, p[0], p[1], terms);
                split_store(Ds + kl * PLD + ql, BC * PLD, ds[0], ds[1], terms);
            }
        }
        __syncthreads();
        // dV += P^T dout, dK += dS^T q: the warp's 16 keys x HD/2 features
        {
            uint32_t ap[kTerms], ad[kTerms], bo[kTerms];
#pragma unroll
            for (int t = 0; t < kTerms; ++t) {
                ap[t] = sP + 2u * (t * BC * PLD);
                ad[t] = sD + 2u * (t * BC * PLD);
                bo[t] = sO + 2u * (t * BR * RW);
            }
            const uint32_t bq[kTerms] = {sQ, 0, 0};
            warp_gemm<NTD, BR, true>(adv, ap, terms, pad, 16 * wr, bo, n_o,
                                     wide, (HD / 2) * wc, terms, lane);
            warp_gemm<NTD, BR, true>(adk, ad, terms, pad, 16 * wr, bq, 1,
                                     wide, (HD / 2) * wc, terms, lane);
        }
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int key = kv0 + 16 * wr + g + 8 * half;
        if (key >= S) continue;
        const long long row = ((static_cast<long long>(b) * S + key) * H + h)
                              * HD;
#pragma unroll
        for (int j = 0; j < NTD; ++j) {
            const int d = (HD / 2) * wc + 8 * j + 2 * tig;
            *reinterpret_cast<float2*>(dk_part + row + d) =
                make_float2(adk[j][2 * half], adk[j][2 * half + 1]);
            *reinterpret_cast<float2*>(dv_part + row + d) =
                make_float2(adv[j][2 * half], adv[j][2 * half + 1]);
        }
    }
}

// the dQ pass: dq (B, S, H, HD) in bf16, one block a (head, batch, query
// tile), the heaviest (last) query tiles first
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const float* __restrict__ lse,
             const float* __restrict__ delta, const bf16* __restrict__ dterms,
             const int* __restrict__ lo, bf16* __restrict__ dq, int S, int H,
             int hkv, float scale_log2, float scale, int terms) {
    using T = Tile<HD>;
    constexpr int QR = T::QR, QC = T::QC, RW = T::RW, SLD = T::SLD;
    constexpr int NTS = QC / 16;     // n8 tiles of a warp's S columns
    constexpr int NTD = HD / 16;     // n8 tiles of a warp's dQ columns
    extern __shared__ __align__(128) uint8_t smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
    bf16* Os = Qs + QR * RW;                        // kTerms planes
    float* lse2 = reinterpret_cast<float*>(Os + kTerms * QR * RW);
    float* dl = lse2 + QR;
    uint8_t* stages = reinterpret_cast<uint8_t*>(dl + QR);
    bf16* Ds = reinterpret_cast<bf16*>(stages + 2 * T::DQ_STAGE);
    // stage st: K, then V
    auto k_of = [&](int st) {
        return reinterpret_cast<bf16*>(stages + st * T::DQ_STAGE);
    };

    const int h = blockIdx.x, b = blockIdx.y;
    const int q0 = (gridDim.z - 1 - blockIdx.z) * QR;
    const int kvh = h / (H / hkv);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wr = warp & 3, wc = warp >> 2;
    const int g = lane >> 2, tig = lane & 3;
    const long long head_row = (static_cast<long long>(b) * H + h) * S;
    const long long plane = static_cast<long long>(gridDim.y) * H * S * HD;
    const int n_o = *lo ? terms : 1;
    const Wide<HD> wide;
    const Padded pad{SLD};

    const bf16* kh = k + (static_cast<long long>(b) * S * hkv + kvh) * HD;
    const bf16* vh = v + (static_cast<long long>(b) * S * hkv + kvh) * HD;
    auto issue = [&](int st, int kv0) {
        load_tile<HD, QC>(k_of(st), kh, static_cast<long long>(hkv) * HD, kv0,
                          S, tid);
        load_tile<HD, QC>(k_of(st) + QC * RW, vh,
                          static_cast<long long>(hkv) * HD, kv0, S, tid);
        cp_async_commit();
    };

    load_tile<HD, QR>(Qs, q + (static_cast<long long>(b) * S * H + h) * HD,
                      static_cast<long long>(H) * HD, q0, S, tid);
    for (int u = 0; u < n_o; ++u)
        load_tile<HD, QR>(Os + u * QR * RW, dterms + head_row * HD
                          + u * plane, HD, q0, S, tid);
    load_row_f32<QR>(lse2, lse + head_row, q0, S, tid);
    load_row_f32<QR>(dl, delta + head_row, q0, S, tid);
    issue(0, 0);

    float adq[NTD][4];
#pragma unroll
    for (int j = 0; j < NTD; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) adq[j][e] = 0.f;

    const uint32_t sQ = smem_u32(Qs), sO = smem_u32(Os), sD = smem_u32(Ds);
    const int n_kv = (min(q0 + QR, S) + QC - 1) / QC;

    for (int it = 0; it < n_kv; ++it) {
        const int st = it & 1, kv0 = it * QC;
        cp_async_wait_all();
        // this step's tiles are in; the last step's reads are done
        __syncthreads();
        if (it + 1 < n_kv) issue(st ^ 1, kv0 + QC);
        const uint32_t sK = smem_u32(k_of(st)), sV = sK + 2u * (QC * RW);

        // S and dP: the warp's 16 query rows x QC/2 keys
        float sc[NTS][4], dp[NTS][4];
#pragma unroll
        for (int j = 0; j < NTS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
        {
            const uint32_t aq[kTerms] = {sQ, 0, 0};
            const uint32_t bk[kTerms] = {sK, 0, 0};
            warp_gemm<NTS, HD, false>(sc, aq, 1, wide, 16 * wr, bk, 1, wide,
                                      (QC / 2) * wc, 1, lane);
            uint32_t ao[kTerms];
#pragma unroll
            for (int u = 0; u < kTerms; ++u) ao[u] = sO + 2u * (u * QR * RW);
            const uint32_t bv[kTerms] = {sV, 0, 0};
            warp_gemm<NTS, HD, false>(dp, ao, n_o, wide, 16 * wr, bv, 1, wide,
                                      (QC / 2) * wc, n_o, lane);
        }
        // dS into shared memory as its terms
#pragma unroll
        for (int j = 0; j < NTS; ++j) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int ql = 16 * wr + g + 8 * half, row = q0 + ql;
                const int kl = (QC / 2) * wc + 8 * j + 2 * tig;
                float ds[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int key = kv0 + kl + e;
                    const bool ok = key <= row && row < S;
                    const float p = ok ? exp2f(fmaf(sc[j][2 * half + e],
                                                    scale_log2,
                                                    -lse2[ql] * kLog2e))
                                       : 0.f;
                    ds[e] = p * (dp[j][2 * half + e] - dl[ql]);
                }
                split_store(Ds + ql * SLD + kl, QR * SLD, ds[0], ds[1], terms);
            }
        }
        __syncthreads();
        // dQ += dS k: the warp's 16 query rows x HD/2 features
        {
            uint32_t ad[kTerms];
#pragma unroll
            for (int t = 0; t < kTerms; ++t) ad[t] = sD + 2u * (t * QR * SLD);
            const uint32_t bk[kTerms] = {sK, 0, 0};
            warp_gemm<NTD, QC, true>(adq, ad, terms, pad, 16 * wr, bk, 1,
                                     wide, (HD / 2) * wc, terms, lane);
        }
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int row = q0 + 16 * wr + g + 8 * half;
        if (row >= S) continue;
        bf16* dst = dq + ((static_cast<long long>(b) * S + row) * H + h) * HD;
#pragma unroll
        for (int j = 0; j < NTD; ++j) {
            const int d = (HD / 2) * wc + 8 * j + 2 * tig;
            *reinterpret_cast<bf162*>(dst + d) = __floats2bfloat162_rn(
                adq[j][2 * half] * scale, adq[j][2 * half + 1] * scale);
        }
    }
}

// dk = scale * sum_g dK partials, dv = sum_g dV partials, in bf16, the
// group's heads summed in order
__global__ void __launch_bounds__(kThreads)
flash_bwd_finish(const float* __restrict__ dk_part,
                 const float* __restrict__ dv_part, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, long long n, int HD, int g,
                 float scale) {
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads
                       + threadIdx.x;
         i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
        const long long base = (i / HD) * g * HD + i % HD;
        float sk = 0.f, sv = 0.f;
        for (int j = 0; j < g; ++j) {
            sk += dk_part[base + static_cast<long long>(j) * HD];
            sv += dv_part[base + static_cast<long long>(j) * HD];
        }
        dk[i] = __float2bfloat16_rn(sk * scale);
        dv[i] = __float2bfloat16_rn(sv);
    }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* lse,
           const void* delta, const void* dterms, const void* lo, void* dq,
           void* dk_part, void* dv_part, int B, int S, int H, int hkv,
           float scale, int terms, cudaStream_t st) {
    using T = Tile<HD>;
    static bool attr_set = false;            // once per instantiation
    if (!attr_set) {
        cudaError_t e = cudaFuncSetAttribute(
            flash_bwd_dkdv<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            T::KV_SMEM);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(
                flash_bwd_dq<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                T::DQ_SMEM);
        if (e != cudaSuccess) return static_cast<int>(e);
        attr_set = true;
    }
    const float scale_log2 = scale * kLog2e;
    const bf16* qb = static_cast<const bf16*>(q);
    const bf16* kb = static_cast<const bf16*>(k);
    const bf16* vb = static_cast<const bf16*>(v);
    const float* lf = static_cast<const float*>(lse);
    const float* df = static_cast<const float*>(delta);
    const bf16* ot = static_cast<const bf16*>(dterms);
    const int* lf_lo = static_cast<const int*>(lo);
    flash_bwd_dkdv<HD><<<dim3(H, B, (S + T::BC - 1) / T::BC), kThreads,
                         T::KV_SMEM, st>>>(
        qb, kb, vb, lf, df, ot, lf_lo, static_cast<float*>(dk_part),
        static_cast<float*>(dv_part), S, H, hkv, scale_log2, terms);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bwd_dq<HD><<<dim3(H, B, (S + T::QR - 1) / T::QR), kThreads,
                       T::DQ_SMEM, st>>>(
        qb, kb, vb, lf, df, ot, lf_lo, static_cast<bf16*>(dq), S, H, hkv,
        scale_log2, scale, terms);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dterms: (terms, B, H, S, hd) bf16 scratch; lo: one int of scratch
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* out, const void* lse, const void* dout,
                         long long dout_sb, long long dout_sh,
                         long long dout_ss, void* dq, void* dk, void* dv,
                         void* dk_part, void* dv_part, void* delta,
                         void* dterms, void* lo, int B, int S, int H, int hkv,
                         int hd, float scale, int terms, void* stream) {
    if (B < 1 || S < 1 || hkv < 1 || H % hkv != 0) return -3;
    if (B > 65535 || H > 65535 || (S + 63) / 64 > 65535) return -4;
    if (terms < 1 || terms > kTerms) return -7;
    // 16-byte copies of q, k and v rows
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)
         | reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dterms))
        & 15u)
        return -5;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e0 = cudaMemsetAsync(lo, 0, sizeof(int), st);
    if (e0 != cudaSuccess) return static_cast<int>(e0);
    const long long rows = static_cast<long long>(B) * H * S;
    flash_bwd_prep<<<static_cast<unsigned>((rows + 7) / 8), kThreads, 0,
                     st>>>(static_cast<const float*>(out),
                           static_cast<const float*>(dout), dout_sb, dout_sh,
                           dout_ss, static_cast<float*>(delta),
                           static_cast<bf16*>(dterms), static_cast<int*>(lo),
                           H, S, hd, rows, terms);
    e0 = cudaGetLastError();
    if (e0 != cudaSuccess) return static_cast<int>(e0);
    int rc;
    switch (hd) {
        case 16: rc = launch<16>(q, k, v, lse, delta, dterms, lo, dq, dk_part, dv_part, B, S, H, hkv, scale, terms, st); break;
        case 32: rc = launch<32>(q, k, v, lse, delta, dterms, lo, dq, dk_part, dv_part, B, S, H, hkv, scale, terms, st); break;
        case 64: rc = launch<64>(q, k, v, lse, delta, dterms, lo, dq, dk_part, dv_part, B, S, H, hkv, scale, terms, st); break;
        case 128: rc = launch<128>(q, k, v, lse, delta, dterms, lo, dq, dk_part, dv_part, B, S, H, hkv, scale, terms, st); break;
        case 256: rc = launch<256>(q, k, v, lse, delta, dterms, lo, dq, dk_part, dv_part, B, S, H, hkv, scale, terms, st); break;
        default: return -2;
    }
    if (rc != 0) return rc;
    const long long n = static_cast<long long>(B) * S * hkv * hd;
    const long long blocks = (n + kThreads - 1) / kThreads;
    flash_bwd_finish<<<static_cast<unsigned>(blocks < 1056 ? blocks : 1056),
                       kThreads, 0, st>>>(
        static_cast<const float*>(dk_part), static_cast<const float*>(dv_part),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, hd, H / hkv,
        scale);
    return static_cast<int>(cudaGetLastError());
}
