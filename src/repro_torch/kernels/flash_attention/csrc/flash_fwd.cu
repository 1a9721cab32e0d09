// Causal GQA flash-attention forward for sm_90a: the prefill's
// self-attention with positions 0..S-1.
//
// Replaces the TPU kernel `_flash_fwd_kernel` of
// src/repro/kernels/flash_attention/kernel.py (Pallas, grid (B, H,
// q blocks, kv blocks), the kv axis sequential with (m, l, acc) in VMEM,
// blocks past the causal frontier skipped, KV head = h // g in the index
// map). Same contract: q (B, S, H, hd), k and v (B, S, Hkv, hd), bf16 or
// float32; out (B, H, S, hd) float32 and lse (B, H, S) float32, with
// q scaled by 1/sqrt(hd) before the products and all arithmetic in
// float32:
//   s = (q * scale) . k,  masked to key <= query,
//   online softmax over kv tiles,  out = acc / max(l, 1e-30),
//   lse = m + log(max(l, 1e-30)).
// Unlike the Pallas kernel it takes any S: the ragged last tiles are
// masked here (key < S), and query rows past S are not written.
//
// Bound on this card: operations. The causal half of the two products
// is 4*B*H*S^2*hd/2 operations against (q + k + v) in and out + lse
// back, some 300 operations per byte at the serving shape (B 4, S 2048,
// H 8, hd 256), above the card's ridge. Design (simple, float32 on the
// CUDA cores, no tensor cores yet): one block of 128 threads per (q tile
// of 32 rows, head, batch); it walks the kv tiles of 32 keys up to the
// causal frontier. q, k and v tiles live in shared memory as float32
// (rows of q and k padded by one float against bank conflicts), which at
// hd 256 is 100 KiB of dynamic shared memory, set with
// cudaFuncSetAttribute. Four threads own one query row: each computes 8
// of the tile's 32 scores with the row's q reused from shared memory, the
// quad reduces max and sum with shuffles, and each thread keeps hd/4 of
// the row's accumulator in registers (64 at hd 256). The next designs
// move the products to wgmma in bf16 with TMA-fed tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 32;            // query rows per block
constexpr int kBK = 32;            // keys per kv tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <int HD>
constexpr size_t smem_bytes() {
    return sizeof(float) * (2 * kBQ * (HD + 1) + kBK * HD + kBQ * (kBK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int S, int H, int hkv,
                 float scale) {
    constexpr int KS = HD + 1;
    constexpr int PS = kBK + 1;
    constexpr int NJ = kBK / 4;      // scores per thread
    constexpr int NA = HD / 4;       // accumulator columns per thread
    extern __shared__ float smem[];
    float* Qs = smem;                // kBQ x KS
    float* Ks = Qs + kBQ * KS;       // kBK x KS
    float* Vs = Ks + kBK * KS;       // kBK x HD
    float* Ps = Vs + kBK * HD;       // kBQ x PS

    const int hh = blockIdx.y, b = blockIdx.z;
    const int kvh = hh / (H / hkv);
    const int q0 = blockIdx.x * kBQ;
    const int tid = threadIdx.x;
    const int r = tid >> 2;          // this thread's query row in the tile
    const int lq = tid & 3;          // its place in the row's quad
    const int my_q = q0 + r;

    for (int e = tid; e < kBQ * HD; e += kThreads) {
        const int rr = e / HD, d = e % HD;
        const int s = q0 + rr;
        float x = 0.0f;
        if (s < S)
            x = to_f32(q[((static_cast<long long>(b) * S + s) * H + hh) * HD
                         + d]) * scale;
        Qs[rr * KS + d] = x;
    }
    float m_i = kNegInf, l_i = 0.0f;
    float acc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0.0f;

    const int q_last = min(q0 + kBQ, S) - 1;
    for (int k0 = 0; k0 <= q_last; k0 += kBK) {
        __syncthreads();             // the previous tile's reads are done
        for (int e = tid; e < kBK * HD; e += kThreads) {
            const int c = e / HD, d = e % HD;
            const int s = k0 + c;
            float kx = 0.0f, vx = 0.0f;
            if (s < S) {
                const long long off =
                    ((static_cast<long long>(b) * S + s) * hkv + kvh) * HD + d;
                kx = to_f32(k[off]);
                vx = to_f32(v[off]);
            }
            Ks[c * KS + d] = kx;
            Vs[c * HD + d] = vx;
        }
        __syncthreads();

        float sc[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) sc[j] = 0.0f;
#pragma unroll 4
        for (int d = 0; d < HD; ++d) {
            const float qv = Qs[r * KS + d];
#pragma unroll
            for (int j = 0; j < NJ; ++j)
                sc[j] += qv * Ks[(lq + 4 * j) * KS + d];
        }
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int key = k0 + lq + 4 * j;
            if (!(key <= my_q && key < S)) sc[j] = kNegInf;
            mx = fmaxf(mx, sc[j]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_i, mx);
        float psum = 0.0f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int key = k0 + lq + 4 * j;
            const float p = (key <= my_q && key < S) ? expf(sc[j] - m_new)
                                                     : 0.0f;
            Ps[r * PS + lq + 4 * j] = p;
            psum += p;
        }
        psum += __shfl_xor_sync(0xffffffffu, psum, 1);
        psum += __shfl_xor_sync(0xffffffffu, psum, 2);
        const float corr = expf(m_i - m_new);
        l_i = l_i * corr + psum;
        m_i = m_new;
        __syncwarp();                // the quad's probabilities are visible
#pragma unroll
        for (int i = 0; i < NA; ++i) acc[i] *= corr;
        for (int c = 0; c < kBK; ++c) {
            const float p = Ps[r * PS + c];
#pragma unroll
            for (int i = 0; i < NA; ++i) acc[i] += p * Vs[c * HD + lq + 4 * i];
        }
    }
    if (my_q < S) {
        const float l_safe = fmaxf(l_i, 1e-30f);
        const long long row = (static_cast<long long>(b) * H + hh) * S + my_q;
#pragma unroll
        for (int i = 0; i < NA; ++i) out[row * HD + lq + 4 * i] = acc[i] / l_safe;
        if (lq == 0) lse[row] = m_i + logf(l_safe);
    }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int S, int H, int hkv, float scale, cudaStream_t st) {
    auto kernel = flash_fwd_kernel<T, HD>;
    constexpr size_t smem = smem_bytes<HD>();
    static bool attr_set = false;            // once per instantiation
    if (!attr_set) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
        attr_set = true;
    }
    const dim3 grid((S + kBQ - 1) / kBQ, H, B);
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<float*>(out),
        static_cast<float*>(lse), S, H, hkv, scale);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                void* out, void* lse, int B, int S, int H, int hkv,
                float scale, cudaStream_t st) {
    switch (hd) {
        case 16: return launch<T, 16>(q, k, v, out, lse, B, S, H, hkv, scale, st);
        case 32: return launch<T, 32>(q, k, v, out, lse, B, S, H, hkv, scale, st);
        case 64: return launch<T, 64>(q, k, v, out, lse, B, S, H, hkv, scale, st);
        case 128: return launch<T, 128>(q, k, v, out, lse, B, S, H, hkv, scale, st);
        case 256: return launch<T, 256>(q, k, v, out, lse, B, S, H, hkv, scale, st);
        default: return -2;
    }
}

}  // namespace

extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         int is_bf16, void* out, void* lse, int B, int S,
                         int H, int hkv, int hd, float scale, void* stream) {
    if (B < 1 || S < 1 || hkv < 1 || H % hkv != 0) return -3;
    if (B > 65535 || H > 65535) return -4;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return is_bf16 ? dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, lse, B, S,
                                                H, hkv, scale, st)
                   : dispatch_hd<float>(hd, q, k, v, out, lse, B, S, H, hkv,
                                        scale, st);
}
