// The latent form of the tiered decode attention, for sm_90a: MLA's
// absorbed decode against the int4 latent tier, with the dequantization
// fused.
//
// Replaces, on the MLA serving path, what the TPU kernel
// `_tiered_decode_kernel` of src/repro/kernels/tiered_attention/
// kernel.py computes for GQA (the reference's MLA decode dequantizes the
// tier in `jnp` and attends with einsums, transformer.py:250-259 and
// mla.py:75-105). It returns the online-softmax partials of every query
// head over tokens [0, dense_len) of one batch row's latent:
//   c[t]    = bf16((nibble - 8) * scale[t, group])       (r wide)
//   s[h, t] = (q_lat[h] . c[t] + q_rope[h] . k_rope[t]) * scale
//   m = max_t s,  l = sum_t exp(s - m),  acc = sum_t exp(s - m) c[t]
// The one dequantized latent serves as the key (with the raw bf16 RoPE
// key beside it) and as the value. An empty tier (dense_len 0) gives m =
// -1e30, l = 0, acc = 0, as the plain version's masked form does.
//
// Bound on this card: operations. Each token brings r/2 bytes of the
// latent, its bf16 scales and p bf16 of RoPE key (400 bytes at r 512, p
// 64, group 64: 0.12 ns at 3.35 TB/s) and costs 2 * H * (2r + p)
// float32 operations (34,816 at H 16: 0.52 ns at 67 TFLOP/s on the CUDA
// cores); at deepseek-v2-lite's decode (B 4, H 16, dense_len 2048) that
// is 0.98 us of bytes against 4.3 us of operations.
//
// Design (a first, simple form on the CUDA cores): a block of 256
// threads per (split of S, batch row) holds all the heads (up to 16, the
// rest zero). Its q (16 x r latent, 16 x p RoPE) sits in shared memory.
// In tiles of 32 tokens:
// - load: the tile's packed latent rows are read as 4-byte words and
//   dequantized once into shared memory as float32 (bf16-rounded), the
//   RoPE rows likewise; rows past dense_len are zeros. Row strides are
//   padded by 4 floats, so that a 16-byte read of 8 lanes on 8 rows hits
//   distinct banks.
// - scores: warp w takes heads 2w and 2w+1, one token a lane, and dots
//   the lane's row with both heads' q (read as broadcasts); then the
//   tile's online softmax for those heads: one warp max and one warp sum
//   a head, the rescale factor and each token's p into shared memory.
// - acc: each thread owns two features of every head's acc in registers
//   (16 x 2), rescales them once a tile and adds p * c over the tile's
//   tokens from shared memory.
// Each token's latent is loaded and dequantized once for all 16 heads'
// scores and accumulation. The split kernel writes each block's partial;
// with several splits a merge kernel, one block per (head, batch row),
// rescales the splits' partials to their common max as
// `ref.merge_partials` does and sums them in a fixed order. One call of
// `latent_tier_partial` is one launch of the wrapper: the split kernel,
// then the merge kernel where there are several splits. mma.sync or
// wgmma (16 heads are one m16 tile) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeads = 2 * kWarps;        // 16: two heads a warp
constexpr int kTile = 32;                 // tokens a tile, one a lane
constexpr int kMaxR = 512;
constexpr float kNegInf = -1e30f;

__host__ __device__ constexpr int row_stride(int n) { return n + 4; }

size_t split_smem(int r, int p) {
    return sizeof(float) * (static_cast<size_t>(kHeads) * (r + p)
                            + kTile * (row_stride(r) + row_stride(p))
                            + kTile * kHeads + kHeads);
}

// (nib - 8) * scale rounded to bf16, the nibble's float formed by placing
// it in the mantissa of 2^23 (exact)
__device__ __forceinline__ float deq_bf16(uint32_t nib, float scale) {
    const float x = (__uint_as_float(0x4B000000u | nib) - 8388616.0f) * scale;
    return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__global__ void __launch_bounds__(kThreads, 2)
latent_split_kernel(const float* __restrict__ q_lat,
                    const float* __restrict__ q_rope,
                    const uint8_t* __restrict__ c4,
                    const __nv_bfloat16* __restrict__ c4_sc,
                    const __nv_bfloat16* __restrict__ krope,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    float* __restrict__ acc_out, int S, int S_raw, int H,
                    int r, int p, int group, int dense_len,
                    int split_tokens, float scale) {
    extern __shared__ __align__(16) float smem[];
    const int CS = row_stride(r), KS = row_stride(p);
    float* qs = smem;                                  // [16][r]
    float* qr = qs + kHeads * r;                       // [16][p]
    float* cs = qr + kHeads * p;                       // [32][CS]
    float* ks = cs + kTile * CS;                       // [32][KS]
    float* ps = ks + kTile * KS;                       // [32][16]
    float* corr = ps + kTile * kHeads;                 // [16]

    const int split = blockIdx.x, b = blockIdx.y, nsplit = gridDim.x;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int t_begin = split * split_tokens;
    const int t_end = min(t_begin + split_tokens, dense_len);
    const int n_sc = r / group, half = r / 2;

    // q of this batch row; heads H..15 get zeros (their results are
    // never written)
    for (int e = tid; e < kHeads * r; e += kThreads) {
        const int h = e / r;
        qs[e] = h < H ? q_lat[(static_cast<long long>(b) * H + h) * r
                              + (e - h * r)] : 0.0f;
    }
    for (int e = tid; e < kHeads * p; e += kThreads) {
        const int h = e / p;
        qr[e] = h < H ? q_rope[(static_cast<long long>(b) * H + h) * p
                               + (e - h * p)] : 0.0f;
    }

    const int h0 = 2 * warp, h1 = 2 * warp + 1;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
    // this thread's two features of every head's acc
    const int f0 = 2 * tid;
    float acc[kHeads][2];
#pragma unroll
    for (int h = 0; h < kHeads; ++h) acc[h][0] = acc[h][1] = 0.0f;

    for (int t0 = t_begin; t0 < t_end; t0 += kTile) {
        __syncthreads();             // q is in; the last tile is consumed
        // the tile's latent, dequantized once, 8 features a word
        const int words = r / 8;
        for (int e = tid; e < kTile * words; e += kThreads) {
            const int t = e / words, w = e - t * words;
            const int tok = t0 + t;
            float* dst = cs + t * CS + w * 8;
            if (tok < t_end) {
                const long long row = static_cast<long long>(b) * S + tok;
                const uint32_t word = *reinterpret_cast<const uint32_t*>(
                    c4 + row * half + w * 4);
                const __nv_bfloat16* sc = c4_sc + row * n_sc;
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    dst[j] = deq_bf16((word >> (4 * j)) & 15u,
                                      __bfloat162float(sc[(w * 8 + j)
                                                          / group]));
            } else {
#pragma unroll
                for (int j = 0; j < 8; ++j) dst[j] = 0.0f;
            }
        }
        // the tile's RoPE keys, two a word
        const int pw = p / 2;
        for (int e = tid; e < kTile * pw; e += kThreads) {
            const int t = e / pw, w = e - t * pw;
            const int tok = t0 + t;
            float lo = 0.0f, hi = 0.0f;
            if (tok < t_end) {
                const __nv_bfloat162 v = *reinterpret_cast<
                    const __nv_bfloat162*>(
                    krope + (static_cast<long long>(b) * S_raw + tok) * p
                    + 2 * w);
                lo = __low2float(v);
                hi = __high2float(v);
            }
            ks[t * KS + 2 * w] = lo;
            ks[t * KS + 2 * w + 1] = hi;
        }
        __syncthreads();

        // scores of this warp's two heads, one token a lane
        const bool valid = t0 + lane < t_end;
        if (h0 < H) {
            const float* crow = cs + lane * CS;
            const float* krow = ks + lane * KS;
            float s0 = 0.0f, s1 = 0.0f;
#pragma unroll 4
            for (int f = 0; f < r; f += 4) {
                const float4 cv = *reinterpret_cast<const float4*>(crow + f);
                s0 += dot4(*reinterpret_cast<const float4*>(qs + h0 * r + f),
                           cv);
                s1 += dot4(*reinterpret_cast<const float4*>(qs + h1 * r + f),
                           cv);
            }
            float u0 = 0.0f, u1 = 0.0f;
#pragma unroll 4
            for (int f = 0; f < p; f += 4) {
                const float4 kv = *reinterpret_cast<const float4*>(krow + f);
                u0 += dot4(*reinterpret_cast<const float4*>(qr + h0 * p + f),
                           kv);
                u1 += dot4(*reinterpret_cast<const float4*>(qr + h1 * p + f),
                           kv);
            }
            // the tile's online softmax (lane 0's token is always valid)
            const float x0 = valid ? (s0 + u0) * scale : -INFINITY;
            const float x1 = valid ? (s1 + u1) * scale : -INFINITY;
            const float mx0 = fmaxf(m0, warp_max(x0));
            const float mx1 = fmaxf(m1, warp_max(x1));
            const float p0 = expf(x0 - mx0), p1 = expf(x1 - mx1);
            const float c0 = expf(m0 - mx0), c1 = expf(m1 - mx1);
            l0 = l0 * c0 + warp_sum(p0);
            l1 = l1 * c1 + warp_sum(p1);
            m0 = mx0;
            m1 = mx1;
            ps[lane * kHeads + h0] = p0;
            ps[lane * kHeads + h1] = p1;
            if (lane == 0) {
                corr[h0] = c0;
                corr[h1] = c1;
            }
        } else {
            ps[lane * kHeads + h0] = 0.0f;
            ps[lane * kHeads + h1] = 0.0f;
            if (lane == 0) corr[h0] = corr[h1] = 1.0f;
        }
        __syncthreads();

        // acc: two features of every head, rescaled once, then p * c
        if (f0 < r) {
#pragma unroll
            for (int h = 0; h < kHeads; ++h) {
                acc[h][0] *= corr[h];
                acc[h][1] *= corr[h];
            }
#pragma unroll 2
            for (int t = 0; t < kTile; ++t) {
                const float2 cv = *reinterpret_cast<const float2*>(
                    cs + t * CS + f0);
                const float4* pt = reinterpret_cast<const float4*>(
                    ps + t * kHeads);
#pragma unroll
                for (int q4 = 0; q4 < kHeads / 4; ++q4) {
                    const float4 pv = pt[q4];
                    acc[4 * q4][0] += pv.x * cv.x;
                    acc[4 * q4][1] += pv.x * cv.y;
                    acc[4 * q4 + 1][0] += pv.y * cv.x;
                    acc[4 * q4 + 1][1] += pv.y * cv.y;
                    acc[4 * q4 + 2][0] += pv.z * cv.x;
                    acc[4 * q4 + 2][1] += pv.z * cv.y;
                    acc[4 * q4 + 3][0] += pv.w * cv.x;
                    acc[4 * q4 + 3][1] += pv.w * cv.y;
                }
            }
        }
    }

    // this block's partial: (b, split) of (B, nsplit, H[, r])
    const long long part = static_cast<long long>(b) * nsplit + split;
    if (lane == 0 && h0 < H) {
        m_out[part * H + h0] = m0;
        l_out[part * H + h0] = l0;
        if (h1 < H) {
            m_out[part * H + h1] = m1;
            l_out[part * H + h1] = l1;
        }
    }
    if (f0 < r) {
#pragma unroll
        for (int h = 0; h < kHeads; ++h)
            if (h < H)
                *reinterpret_cast<float2*>(acc_out + (part * H + h) * r + f0) =
                    make_float2(acc[h][0], acc[h][1]);
    }
}

constexpr int kMergeThreads = 256;

__device__ __forceinline__ float block_reduce(float x, bool is_max,
                                              float* red) {
    for (int off = 16; off > 0; off >>= 1) {
        const float y = __shfl_xor_sync(0xffffffffu, x, off);
        x = is_max ? fmaxf(x, y) : x + y;
    }
    __syncthreads();                 // red is free
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
    __syncthreads();
    x = red[0];
    for (int w = 1; w < kMergeThreads / 32; ++w)
        x = is_max ? fmaxf(x, red[w]) : x + red[w];
    return x;
}

// one block per (head, batch row): the splits' partials rescaled to their
// common max and summed in a fixed order: each thread takes 4 features of
// every SG-th split, then the SG sums are added in order
__global__ void __launch_bounds__(kMergeThreads)
latent_merge_kernel(const float* __restrict__ m_part,
                    const float* __restrict__ l_part,
                    const float* __restrict__ acc_part,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    float* __restrict__ acc_out, int nsplit, int H, int r) {
    extern __shared__ float cs[];                      // nsplit
    __shared__ float red[kMergeThreads / 32];
    __shared__ float4 sums[kMergeThreads];
    const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
    const long long first = static_cast<long long>(b) * nsplit * H + h;

    float mx = kNegInf;
    for (int s = tid; s < nsplit; s += kMergeThreads)
        mx = fmaxf(mx, m_part[first + static_cast<long long>(s) * H]);
    mx = block_reduce(mx, true, red);
    float sum = 0.0f;
    for (int s = tid; s < nsplit; s += kMergeThreads) {
        const long long i = first + static_cast<long long>(s) * H;
        const float c = expf(m_part[i] - mx);
        cs[s] = c;
        sum += l_part[i] * c;
    }
    // its barriers also publish cs
    sum = block_reduce(sum, false, red);
    const int nq = r / 4, sg_n = kMergeThreads / nq;
    const int col = tid % nq, sg = tid / nq;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (sg < sg_n) {
        for (int s = sg; s < nsplit; s += sg_n) {
            const float4 x = reinterpret_cast<const float4*>(
                acc_part + (first + static_cast<long long>(s) * H) * r)[col];
            const float c = cs[s];
            a.x += c * x.x;
            a.y += c * x.y;
            a.z += c * x.z;
            a.w += c * x.w;
        }
    }
    sums[tid] = a;
    __syncthreads();
    if (sg == 0) {
        for (int o = 1; o < sg_n; ++o) {
            const float4 x = sums[o * nq + col];
            a.x += x.x;
            a.y += x.y;
            a.z += x.z;
            a.w += x.w;
        }
        reinterpret_cast<float4*>(
            acc_out + (static_cast<long long>(b) * H + h) * r)[col] = a;
    }
    if (tid == 0) {
        m_out[static_cast<long long>(b) * H + h] = mx;
        l_out[static_cast<long long>(b) * H + h] = sum;
    }
}

}  // namespace

extern "C" int latent_tier_partial(
        const void* q_lat, const void* q_rope, const void* c4,
        const void* c4_sc, const void* krope, void* m, void* l, void* acc,
        void* m_part, void* l_part, void* acc_part, int B, int S, int S_raw,
        int H, int r, int p, int group, int dense_len, int split_tokens,
        int nsplit, float scale, void* stream) {
    if (H < 1 || H > kHeads) return -2;
    if (r < 64 || r > kMaxR || r % 64 != 0) return -3;
    if (p != 16 && p != 32 && p != 64) return -3;
    if (group < 2 || group % 2 != 0 || r % group != 0) return -4;
    if (dense_len < 0 || dense_len > S || S_raw < S) return -5;
    if (B < 1 || B > 65535) return -6;
    // the wrapper's plan: ceil(dense_len / split_tokens) splits, at least
    // one, tiles of 32 tokens, and partial buffers wherever there are
    // several
    if (split_tokens < kTile || split_tokens % kTile != 0
        || nsplit != (dense_len > 0 ? (dense_len + split_tokens - 1)
                                          / split_tokens : 1)
        || nsplit > 12288
        || (nsplit > 1 && (!m_part || !l_part || !acc_part)))
        return -7;
    // latent rows are read 4 bytes at a time, RoPE pairs 4, acc 8 (16 in
    // the merge)
    if ((reinterpret_cast<uintptr_t>(c4) | reinterpret_cast<uintptr_t>(krope))
        & 3u)
        return -8;
    if ((reinterpret_cast<uintptr_t>(acc)
         | reinterpret_cast<uintptr_t>(acc_part)) & 15u)
        return -8;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool merge = nsplit > 1;
    const size_t smem = split_smem(r, p);
    static size_t smem_set = 48 * 1024;      // the default limit
    if (smem > smem_set) {
        cudaError_t e = cudaFuncSetAttribute(
            latent_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(split_smem(kMaxR, 64)));
        if (e != cudaSuccess) return static_cast<int>(e);
        smem_set = split_smem(kMaxR, 64);
    }
    latent_split_kernel<<<dim3(nsplit, B), kThreads, smem, st>>>(
        static_cast<const float*>(q_lat), static_cast<const float*>(q_rope),
        static_cast<const uint8_t*>(c4),
        static_cast<const __nv_bfloat16*>(c4_sc),
        static_cast<const __nv_bfloat16*>(krope),
        static_cast<float*>(merge ? m_part : m),
        static_cast<float*>(merge ? l_part : l),
        static_cast<float*>(merge ? acc_part : acc), S, S_raw, H, r, p,
        group, dense_len, split_tokens, scale);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || !merge) return static_cast<int>(e);
    latent_merge_kernel<<<dim3(H, B), kMergeThreads, sizeof(float) * nsplit,
                          st>>>(
        static_cast<const float*>(m_part), static_cast<const float*>(l_part),
        static_cast<const float*>(acc_part), static_cast<float*>(m),
        static_cast<float*>(l), static_cast<float*>(acc), nsplit, H, r);
    return static_cast<int>(cudaGetLastError());
}
