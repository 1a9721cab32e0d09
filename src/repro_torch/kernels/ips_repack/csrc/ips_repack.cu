// The in-place switch: bf16 values -> symmetric groupwise int4 (two
// nibbles per byte) + one scale per group, for sm_90a.
//
// Replaces the TPU kernel `_repack_kernel` of
// src/repro/kernels/ips_repack/kernel.py (Pallas, one arena page per
// program, output aliased over the input). Its two passes, per group of
// `group` values along the feature axis:
//   pass 1  scale = absmax * float32(1/7)
//   pass 2  q = rint(x / max(scale, 1e-12)), clip to +-7, +8, pack
//           value 2i in the low nibble and 2i+1 in the high nibble
// The reference's text divides by 7; compiled (jax.jit, and the Pallas
// kernel) XLA multiplies by the rounded reciprocal instead, and this
// kernel does what the compiled reference does. rint is
// round-half-to-even, as jnp.round; the division by the scale is IEEE
// (nvcc's default -prec-div=true), so the bytes and scales equal the
// compiled reference's `quantize_int4` bit for bit.
//
// Two entry points share the device code:
//   ips_quantize_rows  the tier form on the serving path: x (N, feat)
//                      bf16 or float32 -> packed (N, feat/2) uint8,
//                      scales (N, feat/group) float32. Called at every
//                      prefill fill and every repack of the tiered cache.
//   ips_repack_arena   the TPU kernel's contract: an arena of pages,
//                      each `tokens * feat` bf16 values, densified in
//                      place: packed bytes, then the bf16 scales, then
//                      the stale tail left as it was.
//
// Bound on this card: bytes. Each value is read once (2 bytes) and
// leaves 0.5 + 4/group (tier) or 0.5 + 2/group (arena) bytes; the
// arithmetic is a few operations per value. Design: one thread per pair
// of values (one output byte), reading the pair as one 32-bit word. The
// `group/2` threads of a group are neighbouring lanes of one warp, so
// the group's absmax is a butterfly of shuffles and no value goes
// through shared memory. Hence group/2 must be a power of two <= 32
// (group 2..64; the default is 64); the wrapper refuses others.
//
// The arena form writes over what it reads. Packed byte i lands at page
// offset i, inside the bf16 bytes of pair i/4, which this block has read
// already: the block walks the page in pair order, blockDim pairs at a
// time, with a barrier between the reads and the writes of each step
// (writes of step k end below the reads of step k+1). The scales land at
// `tokens*feat/2 + 2*g`, inside bf16 bytes not read yet, so the page's
// scales stay in shared memory (tokens * feat/group bf16, 8 KiB at the
// default 256 x 1024 / 64) and are written after the whole page is read.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;
constexpr float kInvInt4Max = 1.0f / 7.0f;   // float32(1/7)

__device__ __forceinline__ float bf16_bits(uint32_t bits16) {
    return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ uint32_t nibble(float x, float safe) {
    float q = rintf(x / safe);
    q = fminf(fmaxf(q, -7.0f), 7.0f);
    return static_cast<uint32_t>(static_cast<int>(q + 8.0f));
}

// Pass 1 and 2 for one pair; every lane of the warp must call it (the
// shuffles name the whole warp). Returns the packed byte; `scale` gets
// the group's float32 scale.
__device__ __forceinline__ uint8_t quant_pair(float x0, float x1, int tpg,
                                              float* scale) {
    float a = fmaxf(fabsf(x0), fabsf(x1));
    for (int off = tpg >> 1; off > 0; off >>= 1)
        a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
    const float s = a * kInvInt4Max;
    *scale = s;
    const float safe = fmaxf(s, 1e-12f);
    return static_cast<uint8_t>(nibble(x0, safe) | (nibble(x1, safe) << 4));
}

template <bool BF16_IN>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const void* __restrict__ x, uint8_t* __restrict__ packed,
                     float* __restrict__ scales, long long n_pairs,
                     int group) {
    const int tpg = group >> 1;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    // `base` is uniform over the block, so whole warps stay in the loop
    for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x;
         base < n_pairs; base += stride) {
        const long long i = base + threadIdx.x;
        const bool ok = i < n_pairs;
        float x0 = 0.0f, x1 = 0.0f;
        if (ok) {
            if (BF16_IN) {
                const uint32_t w = static_cast<const uint32_t*>(x)[i];
                x0 = bf16_bits(w & 0xffffu);
                x1 = bf16_bits(w >> 16);
            } else {
                const float2 w = static_cast<const float2*>(x)[i];
                x0 = w.x;
                x1 = w.y;
            }
        }
        float s;
        const uint8_t byte = quant_pair(x0, x1, tpg, &s);
        if (ok) {
            packed[i] = byte;
            if ((i & (tpg - 1)) == 0) scales[(2 * i) / group] = s;
        }
    }
}

__global__ void __launch_bounds__(kThreads)
repack_arena_kernel(uint8_t* arena, long long page_bytes,
                    int tokens, int feat, int group) {
    extern __shared__ unsigned short page_scales[];     // bf16 bits
    const int tpg = group >> 1;
    uint8_t* page = arena + static_cast<long long>(blockIdx.x) * page_bytes;
    const long long n_pairs = static_cast<long long>(tokens) * feat / 2;
    const long long packed_bytes = n_pairs;
    const uint32_t* words = reinterpret_cast<const uint32_t*>(page);
    for (long long base = 0; base < n_pairs; base += blockDim.x) {
        const long long i = base + threadIdx.x;
        const bool ok = i < n_pairs;
        const uint32_t w = ok ? words[i] : 0u;
        __syncthreads();            // every read of this step precedes any write
        float s;
        const uint8_t byte = quant_pair(bf16_bits(w & 0xffffu),
                                        bf16_bits(w >> 16), tpg, &s);
        if (ok) {
            page[i] = byte;
            if ((i & (tpg - 1)) == 0)
                page_scales[(2 * i) / group] =
                    __bfloat16_as_ushort(__float2bfloat16_rn(s));
        }
    }
    __syncthreads();                // the whole page is read
    const long long n_groups = static_cast<long long>(tokens) * (feat / group);
    uint8_t* out = page + packed_bytes;
    const uint8_t* src = reinterpret_cast<const uint8_t*>(page_scales);
    for (long long b = threadIdx.x; b < 2 * n_groups; b += blockDim.x)
        out[b] = src[b];
}

int check_group(int feat, int group) {
    if (group < 2 || group > 64 || (group & (group - 1)) != 0) return -2;
    if (feat <= 0 || feat % group != 0) return -3;
    return 0;
}

}  // namespace

extern "C" int ips_quantize_rows(const void* x, int x_is_bf16, void* packed,
                                 void* scales, long long n_rows, int feat,
                                 int group, void* stream) {
    const int bad = check_group(feat, group);
    if (bad) return bad;
    if (n_rows < 0) return -4;
    const long long n_pairs = n_rows * feat / 2;
    if (n_pairs == 0) return 0;
    long long blocks = (n_pairs + kThreads - 1) / kThreads;
    if (blocks > 132 * 64) blocks = 132 * 64;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (x_is_bf16)
        quantize_rows_kernel<true><<<static_cast<int>(blocks), kThreads, 0, st>>>(
            x, static_cast<uint8_t*>(packed), static_cast<float*>(scales),
            n_pairs, group);
    else
        quantize_rows_kernel<false><<<static_cast<int>(blocks), kThreads, 0, st>>>(
            x, static_cast<uint8_t*>(packed), static_cast<float*>(scales),
            n_pairs, group);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int ips_repack_arena(void* arena, long long pages,
                                long long page_bytes, int tokens, int feat,
                                int group, void* stream) {
    const int bad = check_group(feat, group);
    if (bad) return bad;
    const long long data_bytes = 2LL * tokens * feat;
    if (tokens <= 0 || page_bytes < data_bytes || page_bytes % 4 != 0)
        return -5;
    if (pages <= 0) return 0;
    if (pages > 0x7fffffffLL) return -6;
    const long long smem = 2LL * tokens * (feat / group);
    if (smem > kMaxSmem) return -7;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            repack_arena_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    repack_arena_kernel<<<static_cast<int>(pages), kThreads,
                          static_cast<size_t>(smem),
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint8_t*>(arena), page_bytes, tokens, feat, group);
    return static_cast<int>(cudaGetLastError());
}
