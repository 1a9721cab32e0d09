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
// operations, the bound chip_smoke.py reports. Design: the
// S axis becomes a loop inside one block per (batch, KV head), 32 tokens
// per step: the block dequantizes the step's k and v into shared memory
// (float32, k rows padded against bank conflicts), computes the G x 32
// scores, updates (m, l) with one warp per query head, and rescales and
// accumulates acc (G x hd, held in registers across the loop). The loop
// stops at dense_len: blocks past it are masked in the reference and add
// nothing. At the serving shapes this is B * Hkv = 4 blocks on 132 SMs:
// the kernel runs at the rate a few SMs can pull, not the card's; a split
// of S over more blocks, with a merge pass, is the next design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;          // tokens per step; one per lane
constexpr int kMaxG = 16;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_scale(const float* p) { return *p; }
__device__ __forceinline__ float load_scale(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}

template <bool DEQ_BF16>
__device__ __forceinline__ float deq(uint32_t nib, float scale) {
    const float x = static_cast<float>(static_cast<int>(nib) - 8) * scale;
    return DEQ_BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__device__ __forceinline__ float warp_max(float x) {
    for (int off = 16; off > 0; off >>= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
    for (int off = 16; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

template <typename SC, bool DEQ_BF16, int HD>
__global__ void __launch_bounds__(kThreads)
tiered_decode_kernel(const float* __restrict__ q,
                     const uint8_t* __restrict__ k4,
                     const SC* __restrict__ ksc,
                     const uint8_t* __restrict__ v4,
                     const SC* __restrict__ vsc,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     float* __restrict__ acc_out, int S, int hkv, int G,
                     int group, int dense_len, float scale) {
    constexpr int HALF = HD / 2;
    constexpr int KS = HD + 1;                       // padded k row
    constexpr int ACC = (kMaxG * HD + kThreads - 1) / kThreads;
    extern __shared__ float smem[];
    float* qs = smem;                                // G x HD
    float* ks = qs + G * HD;                         // kTile x KS
    float* vs = ks + kTile * KS;                     // kTile x HD
    float* ps = vs + kTile * HD;                     // G x kTile
    float* m_s = ps + G * kTile;                     // G
    float* l_s = m_s + kMaxG;                        // G
    float* c_s = l_s + kMaxG;                        // G

    const int bh = blockIdx.x;                       // b * hkv + h
    const int b = bh / hkv, h = bh % hkv;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int n_sc = HD / group;

    for (int e = tid; e < G * HD; e += kThreads)
        qs[e] = q[static_cast<long long>(bh) * G * HD + e];
    if (tid < G) {
        m_s[tid] = kNegInf;
        l_s[tid] = 0.0f;
    }
    float acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;

    for (int t0 = 0; t0 < dense_len; t0 += kTile) {
        const int nt = min(kTile, dense_len - t0);
        __syncthreads();          // the previous step's reads are done
        for (int e = tid; e < kTile * HALF; e += kThreads) {
            const int t = e / HALF, j = e % HALF;
            float k0 = 0.0f, k1 = 0.0f, v0 = 0.0f, v1 = 0.0f;
            if (t < nt) {
                const long long row =
                    (static_cast<long long>(b) * S + t0 + t) * hkv + h;
                const int gi = (2 * j) / group;
                const float sk = load_scale(ksc + row * n_sc + gi);
                const float sv = load_scale(vsc + row * n_sc + gi);
                const uint32_t kb = k4[row * HALF + j];
                const uint32_t vb = v4[row * HALF + j];
                k0 = deq<DEQ_BF16>(kb & 15u, sk);
                k1 = deq<DEQ_BF16>(kb >> 4, sk);
                v0 = deq<DEQ_BF16>(vb & 15u, sv);
                v1 = deq<DEQ_BF16>(vb >> 4, sv);
            }
            ks[t * KS + 2 * j] = k0;
            ks[t * KS + 2 * j + 1] = k1;
            vs[t * HD + 2 * j] = v0;
            vs[t * HD + 2 * j + 1] = v1;
        }
        __syncthreads();
        for (int e = tid; e < G * kTile; e += kThreads) {
            const int g = e / kTile, t = e % kTile;
            float s = 0.0f;
#pragma unroll 8
            for (int d = 0; d < HD; ++d) s += qs[g * HD + d] * ks[t * KS + d];
            ps[e] = t < nt ? s * scale : kNegInf;
        }
        __syncthreads();
        for (int g = warp; g < G; g += kThreads / 32) {
            const float s = ps[g * kTile + lane];
            const float m_prev = m_s[g];
            const float m_new = fmaxf(m_prev, warp_max(s));
            const float p = lane < nt ? expf(s - m_new) : 0.0f;
            ps[g * kTile + lane] = p;
            const float psum = warp_sum(p);
            if (lane == 0) {
                const float c = expf(m_prev - m_new);
                c_s[g] = c;
                l_s[g] = l_s[g] * c + psum;
                m_s[g] = m_new;
            }
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < ACC; ++i) {
            const int idx = tid + i * kThreads;
            if (idx < G * HD) {
                const int g = idx / HD, d = idx % HD;
                float a = acc[i] * c_s[g];
                for (int t = 0; t < nt; ++t)
                    a += ps[g * kTile + t] * vs[t * HD + d];
                acc[i] = a;
            }
        }
    }
    __syncthreads();
    const long long out0 = static_cast<long long>(bh) * G;
    if (tid < G) {
        m_out[out0 + tid] = m_s[tid];
        l_out[out0 + tid] = l_s[tid];
    }
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
        const int idx = tid + i * kThreads;
        if (idx < G * HD) acc_out[out0 * HD + idx] = acc[i];
    }
}

size_t smem_bytes(int G, int hd) {
    return sizeof(float) * (static_cast<size_t>(G) * hd + kTile * (hd + 1)
                            + kTile * hd + G * kTile + 3 * kMaxG);
}

template <typename SC, bool DEQ_BF16, int HD>
int launch(const void* q, const void* k4, const void* ksc, const void* v4,
           const void* vsc, void* m, void* l, void* acc, int B, int S,
           int hkv, int G, int group, int dense_len, float scale,
           cudaStream_t st) {
    auto kernel = tiered_decode_kernel<SC, DEQ_BF16, HD>;
    const size_t smem = smem_bytes(G, HD);
    static bool attr_set = false;            // once per instantiation
    if (!attr_set) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem_bytes(kMaxG, HD)));
        if (e != cudaSuccess) return static_cast<int>(e);
        attr_set = true;
    }
    kernel<<<B * hkv, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const uint8_t*>(k4),
        static_cast<const SC*>(ksc), static_cast<const uint8_t*>(v4),
        static_cast<const SC*>(vsc), static_cast<float*>(m),
        static_cast<float*>(l), static_cast<float*>(acc), S, hkv, G, group,
        dense_len, scale);
    return static_cast<int>(cudaGetLastError());
}

template <typename SC, bool DEQ_BF16>
int dispatch_hd(int hd, const void* q, const void* k4, const void* ksc,
                const void* v4, const void* vsc, void* m, void* l, void* acc,
                int B, int S, int hkv, int G, int group, int dense_len,
                float scale, cudaStream_t st) {
#define TIERED_HD(N)                                                        \
    case N:                                                                 \
        return launch<SC, DEQ_BF16, N>(q, k4, ksc, v4, vsc, m, l, acc, B,  \
                                       S, hkv, G, group, dense_len, scale, \
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

extern "C" int tiered_dense_partial(const void* q, const void* k4,
                                    const void* ksc, const void* v4,
                                    const void* vsc, int sc_is_bf16,
                                    int deq_bf16, void* m, void* l, void* acc,
                                    int B, int S, int hkv, int G, int hd,
                                    int group, int dense_len, float scale,
                                    void* stream) {
    if (G < 1 || G > kMaxG) return -3;
    if (group < 2 || hd % group != 0 || group % 2 != 0) return -4;
    if (dense_len < 0 || dense_len > S) return -5;
    if (B < 1 || hkv < 1) return -6;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (sc_is_bf16)
        return deq_bf16
            ? dispatch_hd<__nv_bfloat16, true>(hd, q, k4, ksc, v4, vsc, m, l,
                                               acc, B, S, hkv, G, group,
                                               dense_len, scale, st)
            : dispatch_hd<__nv_bfloat16, false>(hd, q, k4, ksc, v4, vsc, m,
                                                l, acc, B, S, hkv, G, group,
                                                dense_len, scale, st);
    return deq_bf16
        ? dispatch_hd<float, true>(hd, q, k4, ksc, v4, vsc, m, l, acc, B, S,
                                   hkv, G, group, dense_len, scale, st)
        : dispatch_hd<float, false>(hd, q, k4, ksc, v4, vsc, m, l, acc, B, S,
                                    hkv, G, group, dense_len, scale, st);
}
