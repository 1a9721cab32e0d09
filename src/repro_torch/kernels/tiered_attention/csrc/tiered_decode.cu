// Decode attention of one query per (batch, KV head) against the int4
// dense tier, with the dequantization fused, for sm_90a.
//
// Replaces the TPU kernel `_tiered_decode_kernel` of
// src/repro/kernels/tiered_attention/kernel.py (Pallas, grid (batch,
// KV head, S blocks), the S axis sequential with (m, l, acc) carried in
// VMEM). It returns the online-softmax partials of the G query heads of
// each KV head over tokens [0, dense_len):
//   k[t] = (nibble - 8) * scale[t, group]        (the same for v)
//   s[g, t] = (q[g] . k[t]) / sqrt(hd)
//   m = max_t s,  l = sum_t exp(s - m),  acc = sum_t exp(s - m) v[t]
// An empty tier (dense_len 0) gives m = -1e30, l = 0, acc = 0, as the
// reference's masked form does, so the merge with the hot partials
// stays finite.
//
// DEQ_BF16 selects the dequantized type: false keeps float32 (the TPU
// kernel's contract, `dense_tier_partial_ref`); true rounds each
// dequantized value to bf16 first, as the serving path of the reference
// does (`dequantize_int4` with its bf16 default, transformer.py:211).
//
// Bound on this card: operations, narrowly. Each of the dense_len tokens
// brings hd/2 bytes of k and of v plus their bf16 scales (272 bytes at
// hd 256, group 64: 0.081 ns at 3.35 TB/s) and costs 4*G*hd float32
// operations (8,192 at G 8: 0.122 ns at 67 TFLOP/s on the CUDA cores);
// at B 4, dense_len 2048 that is 0.68 us of bytes against 1.00 us of
// operations. At zamba2-1.2b's shape (B 4, Hkv 32, G 1, hd 64) bytes
// bound it: 2048 x 128 (batch, KV head) x 68 bytes, some 5 us.
//
// Design: S is split over blocks, four warps a block, with no block
// barrier per token. The split kernel's grid is (split, KV head, batch).
// With G >= 2 the four warps split the query heads and take the same 32
// tokens at a time; with G = 1 each warp takes its own 32. The wrapper
// picks the tokens a block takes (`split_tokens`, a multiple of that
// step) so that B * Hkv * splits fills the card: 64 splits of 32 tokens
// at gemma-2b's shape (B * Hkv = 4, G 8: 256 blocks, two query heads a
// warp), 8 of 256 at zamba2's (B * Hkv = 128, G 1: 1024 blocks). In a
// step of 32 tokens:
// - every load of the step goes out at once: the token's packed k and v
//   rows go to shared memory by `cp.async` (16 bytes a copy; k rows
//   padded against bank conflicts), with their scales.
// - scores, one token a lane: the lane dequantizes its k row (per
//   element, bf16-rounded in the DEQ_BF16 form) and dots it with each of
//   its warp's query heads' q, which sits in shared memory and is read
//   as broadcasts. No shuffle per token. The loop over the row stays
//   rolled: fully unrolled (some 9,000 instructions of code at G 8) a
//   step ran 1.7x slower on an H100.
// - the online softmax over the step's 32 tokens: one warp max and one
//   warp sum per query head; the warp's (m, l) are the same in every
//   lane.
// - acc: each lane owns 8 features (hd/8 lanes a token, so 32 * 8 / hd
//   tokens side by side) and its warp's query heads' acc of them in
//   registers, rescaled once a step, and adds p * v over the step's
//   tokens from shared memory.
// At the block's end the lanes that took tokens side by side add their
// acc by shuffles, warps that took other tokens merge once through
// shared memory in a fixed order, and the block writes its partial
// (m, l, acc). With one split that partial is the result. Otherwise a
// merge kernel, one block per (query head, batch x KV head), rescales
// the splits' partials to their common max as `ref.merge_partials` does
// and sums them in a fixed order. A split past dense_len cannot occur
// (the wrapper gives ceil(dense_len / split_tokens) splits); one partly
// past it stops at dense_len, its missing tokens masked (p = 0 against
// a zeroed v row); a split or warp with no token contributes m = -1e30,
// l = 0.
// One call of `tiered_dense_partial` is one launch of the wrapper: the
// split kernel, then the merge kernel where there are several splits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_scale(const float* p) { return *p; }
__device__ __forceinline__ float load_scale(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}

// (nib - 8) * scale, the nibble's float formed by placing it in the
// mantissa of 2^23 (exact, and cheaper than an integer conversion)
template <bool DEQ_BF16>
__device__ __forceinline__ float deq(uint32_t nib, float scale) {
    const float x = (__uint_as_float(0x4B000000u | nib) - 8388616.0f) * scale;
    return DEQ_BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
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

// asynchronous copy of N (8 or 16) bytes, global to shared
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(d), "l"(src), "n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// a k row's stride in shared memory: 16 bytes of padding, so that the 8
// lanes of a 16-byte read phase hit distinct banks
__host__ __device__ constexpr int k_stride(int hd) { return hd / 2 + 16; }

// How a block's four warps share the work for GB query heads: GB >= 4
// splits the heads over the four warps (GW heads each), which take the
// same 32 tokens at a time; GB = 1 gives each warp its own 32 tokens.
__host__ __device__ constexpr int head_groups(int gb) {
    return gb < kWarps ? gb : kWarps;
}

// shared memory of a split block, in bytes: each token group's 32 k and
// v rows (packed) and their scales, q (GB heads, zero past G), the
// block's acc and each warp's p
size_t split_smem(int G, int GB, int hd, int n_sc) {
    const size_t ntg = kWarps / head_groups(GB), gw = GB / head_groups(GB);
    return ntg * 32 * (k_stride(hd) + hd / 2)
         + sizeof(float) * (ntg * 32 * 2 * n_sc
                            + static_cast<size_t>(GB + G) * hd
                            + kWarps * gw * 32);
}

template <typename SC, bool DEQ_BF16, int HD, int GB>
__global__ void __launch_bounds__(kThreads, GB == 1 ? 8 : 2)
tiered_split_kernel(const float* __restrict__ q,
                    const uint8_t* __restrict__ k4,
                    const SC* __restrict__ ksc,
                    const uint8_t* __restrict__ v4,
                    const SC* __restrict__ vsc,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    float* __restrict__ acc_out, int S, int hkv, int G,
                    int group, int dense_len, int split_tokens,
                    float scale) {
    constexpr int HALF = HD / 2;                       // packed bytes a row
    constexpr int WB = HALF < 16 ? HALF : 16;          // bytes a copy
    constexpr int NW = HALF / WB;                      // copies a row
    constexpr int KS = k_stride(HD);
    constexpr int LPT = HD / 8 < 32 ? HD / 8 : 32;     // v: lanes a token
    constexpr int TPW = 32 / LPT;                      // v: tokens side by side
    constexpr int NHG = head_groups(GB);               // warps a token group
    constexpr int NTG = kWarps / NHG;                  // token groups
    constexpr int GW = GB / NHG;                       // heads a warp
    const int n_sc = HD / group;
    const int lg = __ffs(group) - 1;                   // group = 2^lg
    extern __shared__ __align__(16) uint8_t smem[];
    uint8_t* krows = smem;                             // [tg][32][KS]
    uint8_t* vrows = krows + NTG * 32 * KS;            // [tg][32][HALF]
    float* kscs = reinterpret_cast<float*>(vrows + NTG * 32 * HALF);
    float* vscs = kscs + NTG * 32 * n_sc;              // [tg][32][n_sc]
    float* qs = vscs + NTG * 32 * n_sc;                // GB x HD
    float* accs = qs + GB * HD;                        // G x HD
    float* ps = accs + G * HD;                         // [warp][GW][32]
    __shared__ float ms[kWarps][kMaxG], ls[kWarps][kMaxG];

    const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const long long bh = static_cast<long long>(b) * hkv + h;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int hg = warp % NHG, tg = warp / NHG;        // heads, tokens
    const int t_begin = split * split_tokens;
    const int t_end = min(t_begin + split_tokens, dense_len);
    uint8_t* my_krows = krows + tg * 32 * KS;
    uint8_t* my_vrows = vrows + tg * 32 * HALF;
    float* my_kscs = kscs + tg * 32 * n_sc;
    float* my_vscs = vscs + tg * 32 * n_sc;
    float* my_ps = ps + warp * GW * 32;
    const float* my_qs = qs + hg * GW * HD;            // this warp's heads

    const float4* q4 = reinterpret_cast<const float4*>(q + bh * G * HD);
    float4* qs4 = reinterpret_cast<float4*>(qs);
    float4* accs4 = reinterpret_cast<float4*>(accs);
    // heads G..GB-1 get q = 0: the loops below run all GB heads
    // unbranched, and those heads' results are never written
#pragma unroll 4
    for (int e = tid; e < GB * HD / 4; e += kThreads) {
        const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        qs4[e] = e < G * HD / 4 ? q4[e] : zero;
        if (e < G * HD / 4) accs4[e] = zero;
    }
    __syncthreads();

    float m[GW], l[GW], acc[GW][8];
#pragma unroll
    for (int k = 0; k < GW; ++k) {
        m[k] = kNegInf;
        l[k] = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[k][i] = 0.0f;
    }
    // the v side: this lane's token within a step and its 8 features
    const int sub = lane / LPT, f0 = (lane % LPT) * 8;

    // steps of 32 tokens, one a lane, the token groups taking them in turn
    for (int t0 = t_begin + 32 * tg; t0 < t_end; t0 += 32 * NTG) {
        const int t = t0 + lane;
        const bool valid = t < t_end;
        const long long row = (static_cast<long long>(b) * S + t) * hkv + h;
        // every load of the step goes out at once: the token's k and v
        // rows into shared memory by cp.async, 16 bytes a copy, and their
        // scales, the group's warps taking every NHG-th copy; a missing
        // token's rows are zeros, so p = 0 meets no NaN
        uint8_t* kdst = my_krows + lane * KS;
        uint8_t* vdst = my_vrows + lane * HALF;
        float* ksd = my_kscs + lane * n_sc;
        float* vsd = my_vscs + lane * n_sc;
        if (valid) {
#pragma unroll
            for (int i = 0; i < (NW + NHG - 1) / NHG; ++i) {
                const int w = hg + i * NHG;
                if (w < NW) {
                    cp_async<WB>(kdst + w * WB, k4 + row * HALF + w * WB);
                    cp_async<WB>(vdst + w * WB, v4 + row * HALF + w * WB);
                }
            }
#pragma unroll 4
            for (int gi = hg; gi < n_sc; gi += NHG) {
                ksd[gi] = load_scale(ksc + row * n_sc + gi);
                vsd[gi] = load_scale(vsc + row * n_sc + gi);
            }
        } else {
            for (int w = hg; w < HALF / 4; w += NHG) {
                reinterpret_cast<uint32_t*>(kdst)[w] = 0u;
                reinterpret_cast<uint32_t*>(vdst)[w] = 0u;
            }
            for (int gi = hg; gi < n_sc; gi += NHG) ksd[gi] = vsd[gi] = 0.0f;
        }
        cp_async_wait_all();
        if constexpr (NHG == 1) __syncwarp(); else __syncthreads();
        // scores against this warp's query heads; the loop over the row
        // stays rolled, so that the kernel's code stays small in the
        // instruction cache
        float s[GW];
#pragma unroll
        for (int k = 0; k < GW; ++k) s[k] = 0.0f;
#pragma unroll 1
        for (int w = 0; w < NW; ++w) {
            uint32_t word[WB / 4];
            if constexpr (WB == 16) {
                const uint4 x = *reinterpret_cast<const uint4*>(kdst + w * 16);
                word[0] = x.x;
                word[1] = x.y;
                word[2] = x.z;
                word[3] = x.w;
            } else {
                const uint2 x = *reinterpret_cast<const uint2*>(kdst + w * 8);
                word[0] = x.x;
                word[1] = x.y;
            }
            const int fw = w * 2 * WB;                 // first feature
            const float s_w = ksd[fw >> lg];
#pragma unroll
            for (int j = 0; j < WB; j += 2) {          // 2 bytes: 4 features
                const int f = fw + 2 * j;
                const uint32_t b2 = (word[j / 4] >> (8 * (j % 4))) & 0xffffu;
                float sa = s_w, sb = s_w;
                if (group < 2 * WB) {                  // several groups a copy
                    sa = ksd[f >> lg];
                    sb = ksd[(f + 2) >> lg];
                }
                const float k0 = deq<DEQ_BF16>(b2 & 15u, sa);
                const float k1 = deq<DEQ_BF16>((b2 >> 4) & 15u, sa);
                const float k2 = deq<DEQ_BF16>((b2 >> 8) & 15u, sb);
                const float k3 = deq<DEQ_BF16>(b2 >> 12, sb);
#pragma unroll
                for (int k = 0; k < GW; ++k) {
                    const float4 qv = *reinterpret_cast<const float4*>(
                        my_qs + k * HD + f);
                    s[k] += qv.x * k0 + qv.y * k1 + qv.z * k2 + qv.w * k3;
                }
            }
        }
        // the step's online softmax: max and sum over the step's tokens
        float c[GW];
#pragma unroll
        for (int k = 0; k < GW; ++k) {
            const float x = valid ? s[k] * scale : -INFINITY;
            const float mx = fmaxf(m[k], warp_max(x));  // lane 0 is valid
            const float p = expf(x - mx);
            c[k] = expf(m[k] - mx);
            l[k] = l[k] * c[k] + warp_sum(p);
            m[k] = mx;
            my_ps[k * 32 + lane] = p;
        }
        __syncwarp();                // the warp's p are in
        // acc: each lane its 8 features, TPW tokens side by side
#pragma unroll
        for (int k = 0; k < GW; ++k)
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[k][i] *= c[k];
#pragma unroll 2
        for (int tt = 0; tt < 32 / TPW; ++tt) {
            const int tl = tt * TPW + sub;
            const uint32_t word = *reinterpret_cast<const uint32_t*>(
                my_vrows + tl * HALF + f0 / 2);
            const float* vrow_sc = my_vscs + tl * n_sc;
            const float s8 = vrow_sc[f0 >> lg];
            float vx[8];
#pragma unroll
            for (int p2 = 0; p2 < 4; ++p2) {
                const float sp = group >= 8 ? s8
                                            : vrow_sc[(f0 + 2 * p2) >> lg];
                const uint32_t byte = (word >> (8 * p2)) & 0xffu;
                vx[2 * p2] = deq<DEQ_BF16>(byte & 15u, sp);
                vx[2 * p2 + 1] = deq<DEQ_BF16>(byte >> 4, sp);
            }
#pragma unroll
            for (int k = 0; k < GW; ++k) {
                const float p = my_ps[k * 32 + tl];
#pragma unroll
                for (int i = 0; i < 8; ++i) acc[k][i] += p * vx[i];
            }
        }
        // the step's buffers are free again
        if constexpr (NHG == 1) __syncwarp(); else __syncthreads();
    }

    // (m, l) are the same in every lane of a warp: the lanes that took
    // other tokens of a step add their acc into lanes 0..LPT-1
#pragma unroll
    for (int off = LPT; off < 32; off <<= 1)
#pragma unroll
        for (int k = 0; k < GW; ++k)
#pragma unroll
            for (int i = 0; i < 8; ++i)
                acc[k][i] += __shfl_xor_sync(0xffffffffu, acc[k][i], off);
    // then the token groups, once, in a fixed order
    if (lane == 0) {
#pragma unroll
        for (int k = 0; k < GW; ++k) {
            const int g = hg * GW + k;
            if (g < G) {
                ms[tg][g] = m[k];
                ls[tg][g] = l[k];
            }
        }
    }
    __syncthreads();
    for (int w = 0; w < NTG; ++w) {
        if (tg == w && sub == 0) {
#pragma unroll
            for (int k = 0; k < GW; ++k) {
                const int g = hg * GW + k;
                if (g >= G) continue;
                float mx = ms[0][g];
#pragma unroll
                for (int o = 1; o < NTG; ++o) mx = fmaxf(mx, ms[o][g]);
                const float cw = expf(m[k] - mx);
#pragma unroll
                for (int i = 0; i < 8; ++i)
                    accs[g * HD + f0 + i] += acc[k][i] * cw;
            }
        }
        __syncthreads();
    }
    const long long part = bh * gridDim.x + split;     // (b, h, split)
    float4* out4 = reinterpret_cast<float4*>(acc_out + part * G * HD);
    for (int e = tid; e < G * HD / 4; e += kThreads) out4[e] = accs4[e];
    if (tid < G) {
        float mx = ms[0][tid];
        for (int o = 1; o < NTG; ++o) mx = fmaxf(mx, ms[o][tid]);
        float sum = 0.0f;
        for (int o = 0; o < NTG; ++o)
            sum += ls[o][tid] * expf(ms[o][tid] - mx);
        m_out[part * G + tid] = mx;
        l_out[part * G + tid] = sum;
    }
}

constexpr int kMergeThreads = 256;

template <int NWARPS>
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
    for (int w = 1; w < NWARPS; ++w) x = is_max ? fmaxf(x, red[w]) : x + red[w];
    return x;
}

// one block per (query head, batch x KV head): the splits' partials
// rescaled to their common max as `ref.merge_partials` rescales them, and
// summed in a fixed order: each thread takes 4 features of every SG-th
// split, then the SG sums are added in order
template <int HD>
__global__ void __launch_bounds__(kMergeThreads)
tiered_merge_kernel(const float* __restrict__ m_part,
                    const float* __restrict__ l_part,
                    const float* __restrict__ acc_part,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    float* __restrict__ acc_out, int nsplit, int G) {
    constexpr int NQ = HD / 4;                         // float4 columns
    constexpr int SG = kMergeThreads / NQ;             // split groups
    extern __shared__ float cs[];                      // nsplit
    __shared__ float red[kMergeThreads / 32];
    __shared__ float4 sums[kMergeThreads];
    const int g = blockIdx.x;
    const long long bh = blockIdx.y;
    const int tid = threadIdx.x;
    const long long first = bh * nsplit * G + g;       // split 0's (m, l)

    float mx = kNegInf;
    for (int s = tid; s < nsplit; s += kMergeThreads)
        mx = fmaxf(mx, m_part[first + static_cast<long long>(s) * G]);
    mx = block_reduce<kMergeThreads / 32>(mx, true, red);
    float sum = 0.0f;
    for (int s = tid; s < nsplit; s += kMergeThreads) {
        const long long i = first + static_cast<long long>(s) * G;
        const float c = expf(m_part[i] - mx);
        cs[s] = c;
        sum += l_part[i] * c;
    }
    // its barriers also publish cs
    sum = block_reduce<kMergeThreads / 32>(sum, false, red);
    const int col = tid % NQ, sg = tid / NQ;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
    for (int s = sg; s < nsplit; s += SG) {
        const float4 x = reinterpret_cast<const float4*>(
            acc_part + (first + static_cast<long long>(s) * G) * HD)[col];
        const float c = cs[s];
        a.x += c * x.x;
        a.y += c * x.y;
        a.z += c * x.z;
        a.w += c * x.w;
    }
    sums[tid] = a;
    __syncthreads();
    if (sg == 0) {
        for (int o = 1; o < SG; ++o) {
            const float4 x = sums[o * NQ + col];
            a.x += x.x;
            a.y += x.y;
            a.z += x.z;
            a.w += x.w;
        }
        reinterpret_cast<float4*>(acc_out + (bh * G + g) * HD)[col] = a;
    }
    if (tid == 0) {
        m_out[bh * G + g] = mx;
        l_out[bh * G + g] = sum;
    }
}

template <typename SC, bool DEQ_BF16, int HD, int GB>
int launch(const void* q, const void* k4, const void* ksc, const void* v4,
           const void* vsc, float* m, float* l, float* acc, float* m_part,
           float* l_part, float* acc_part, int B, int S, int hkv, int G,
           int group, int dense_len, int split_tokens, int nsplit,
           float scale, cudaStream_t st) {
    const bool merge = nsplit > 1;
    auto kernel = tiered_split_kernel<SC, DEQ_BF16, HD, GB>;
    const size_t smem = split_smem(G, GB, HD, HD / group);
    static size_t smem_set = 48 * 1024;      // the default limit
    if (smem > smem_set) {                   // small groups: many scales
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
        smem_set = smem;
    }
    kernel<<<dim3(nsplit, hkv, B), kThreads, smem, st>>>(
            static_cast<const float*>(q), static_cast<const uint8_t*>(k4),
            static_cast<const SC*>(ksc), static_cast<const uint8_t*>(v4),
            static_cast<const SC*>(vsc), merge ? m_part : m,
            merge ? l_part : l, merge ? acc_part : acc, S, hkv, G, group,
            dense_len, split_tokens, scale);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || !merge) return static_cast<int>(e);
    tiered_merge_kernel<HD><<<dim3(G, B * hkv), kMergeThreads,
                              sizeof(float) * nsplit, st>>>(
        m_part, l_part, acc_part, m, l, acc, nsplit, G);
    return static_cast<int>(cudaGetLastError());
}

template <typename SC, bool DEQ_BF16, int HD>
int dispatch_g(const void* q, const void* k4, const void* ksc, const void* v4,
               const void* vsc, float* m, float* l, float* acc,
               float* m_part, float* l_part, float* acc_part, int B, int S,
               int hkv, int G, int group, int dense_len, int split_tokens,
               int nsplit, float scale, cudaStream_t st) {
#define TIERED_G(N)                                                         \
    return launch<SC, DEQ_BF16, HD, N>(q, k4, ksc, v4, vsc, m, l, acc,     \
                                       m_part, l_part, acc_part, B, S,     \
                                       hkv, G, group, dense_len,           \
                                       split_tokens, nsplit, scale, st);
    if (G <= 1) { TIERED_G(1) }
    if (G <= 4) { TIERED_G(4) }
    if (G <= 8) { TIERED_G(8) }
    TIERED_G(16)
#undef TIERED_G
}

template <typename SC, bool DEQ_BF16>
int dispatch_hd(int hd, const void* q, const void* k4, const void* ksc,
                const void* v4, const void* vsc, float* m, float* l,
                float* acc, float* m_part, float* l_part, float* acc_part,
                int B, int S, int hkv, int G, int group, int dense_len,
                int split_tokens, int nsplit, float scale, cudaStream_t st) {
#define TIERED_HD(N)                                                        \
    case N:                                                                 \
        return dispatch_g<SC, DEQ_BF16, N>(q, k4, ksc, v4, vsc, m, l, acc, \
                                           m_part, l_part, acc_part, B, S, \
                                           hkv, G, group, dense_len,       \
                                           split_tokens, nsplit, scale,    \
                                           st);
    switch (hd) {
        TIERED_HD(16)
        TIERED_HD(32)
        TIERED_HD(64)
        TIERED_HD(128)
        TIERED_HD(256)
        default:
            return -2;
    }
#undef TIERED_HD
}

}  // namespace

extern "C" int tiered_dense_partial(
        const void* q, const void* k4, const void* ksc, const void* v4,
        const void* vsc, int sc_is_bf16, int deq_bf16, void* m, void* l,
        void* acc, void* m_part, void* l_part, void* acc_part, int B, int S,
        int hkv, int G, int hd, int group, int dense_len, int split_tokens,
        int nsplit, float scale, void* stream) {
    if (G < 1 || G > kMaxG) return -3;
    if (group < 2 || hd % group != 0 || group % 2 != 0) return -4;
    if (dense_len < 0 || dense_len > S) return -5;
    if (B < 1 || hkv < 1 || B > 65535 || hkv > 65535
        || static_cast<long long>(B) * hkv > 65535)
        return -6;
    // the wrapper's plan: ceil(dense_len / split_tokens) splits, at least
    // one, and partial buffers wherever there are several
    if (split_tokens < 1
        || nsplit != (dense_len > 0 ? (dense_len + split_tokens - 1)
                                          / split_tokens : 1)
        || nsplit > 12288
        || (nsplit > 1 && (!m_part || !l_part || !acc_part)))
        return -7;
    // the packed rows are read 16 bytes a lane (8 at hd 16), q 16
    if (((reinterpret_cast<uintptr_t>(k4) | reinterpret_cast<uintptr_t>(v4))
         & (hd >= 32 ? 15u : 7u)) || (reinterpret_cast<uintptr_t>(q) & 15u))
        return -8;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float *mo = static_cast<float*>(m), *lo = static_cast<float*>(l),
          *ao = static_cast<float*>(acc), *mp = static_cast<float*>(m_part),
          *lp = static_cast<float*>(l_part),
          *ap = static_cast<float*>(acc_part);
#define TIERED_ARGS                                                         \
    hd, q, k4, ksc, v4, vsc, mo, lo, ao, mp, lp, ap, B, S, hkv, G, group,   \
        dense_len, split_tokens, nsplit, scale, st
    if (sc_is_bf16)
        return deq_bf16 ? dispatch_hd<__nv_bfloat16, true>(TIERED_ARGS)
                        : dispatch_hd<__nv_bfloat16, false>(TIERED_ARGS);
    return deq_bf16 ? dispatch_hd<float, true>(TIERED_ARGS)
                    : dispatch_hd<float, false>(TIERED_ARGS);
#undef TIERED_ARGS
}
