// Causal GQA flash-attention forward for sm_90a: the prefill's
// self-attention with positions 0..S-1.
//
// Replaces the TPU kernel `_flash_fwd_kernel` of
// src/repro/kernels/flash_attention/kernel.py (Pallas, grid (B, H,
// q blocks, kv blocks), the kv axis sequential with (m, l, acc) in VMEM,
// blocks past the causal frontier skipped, KV head = h // g in the index
// map). Same contract: q (B, S, H, hd), k and v (B, S, Hkv, hd), bf16 or
// float32; out (B, H, S, hd) float32 and lse (B, H, S) float32:
//   s = (q . k) / sqrt(hd),  masked to key <= query,
//   online softmax over kv tiles,  out = acc / max(l, 1e-30),
//   lse = m + log(max(l, 1e-30)).
// Unlike the Pallas kernel it takes any S: the ragged edge is masked here,
// and query rows past S are not written.
//
// Bound on this card: operations. The causal half of the two products is
// 4*B*H*S^2*hd/2 operations against q, k, v in and out, lse back, some
// 300 operations a byte at gemma-2b's prefill (B 4, S 2048, H 8, Hkv 1,
// hd 256): 68.7 GFLOP, 0.0695 ms at the bf16 tensor-core rate.
//
// bf16 inputs (the serving path) run on the tensor cores:
// - A block owns 128 query rows of one (batch, head): two consumer
//   warpgroups of 64 rows each, and a producer warpgroup whose registers
//   `setmaxnreg` hands to the consumers (24 and 240 a thread). Blocks are
//   launched heavy first (the q tile index is the grid's slowest axis,
//   reversed): late rows see the most keys, and blocks run in no order.
// - One producer thread issues TMA loads (`cp.async.bulk.tensor.4d`,
//   tensor maps (hd, heads, S, B) built on the host, so rows past S come
//   back as zeros) of the block's q once and of K and V tiles of BN keys (64 at
//   hd 256, else 128) into a ring of two stages, each completion counted
//   on an mbarrier; the consumers release a stage on an `empty` barrier.
//   Tiles past the causal frontier are never loaded.
// - A tile lands in shared memory as hd/64 boxes of [rows][64] bf16 with
//   the 128-byte swizzle (32 and 64 bytes at hd 16 and 32, whose rows are
//   that wide), the canonical layout `wgmma` reads through a descriptor.
// - S = Q K^T is `wgmma.mma_async` m64nBNk16 (bf16 in, float32
//   accumulate) with both operands K-major in shared memory; O += P V is
//   m64n(hd)k16 with P from registers and V read MN-major through the
//   transpose bit, so no transposed copy of V is made. O stays in
//   registers: hd/2 float32 a thread, 128 at hd 256.
// - The online softmax is float32 in registers: scores scaled by
//   log2(e)/sqrt(hd) (the scale applied to the float32 scores, never to a
//   rounded q), the causal mask applied before exp2 on the one diagonal
//   tile of each warpgroup, row max and sum over the four threads of a
//   row by shuffles.
// - P reaches the second product in float32, as the TPU kernel and
//   `flash_ref` keep it: split into three bf16 terms (t1 = bf16(P),
//   t2 = bf16(P - t1), t3 = P - t1 - t2, each difference exact in
//   float32), which sum to P exactly, each an m64n(hd)k16 `wgmma` into
//   the same O; l sums P. One bf16 term (as the flash kernels of
//   PyTorch's SDPA round it) moved llava-next-34b's logits at 48 and 60
//   layers 1.3-1.5x further from the plain version's than the plain
//   version's own summation-order floor; two terms still left 9x the
//   float32 error. The three terms triple the PV product's tensor-core
//   work, which the bound above does not count (it counts the
//   function's operations).
// Shared memory at hd 256: q 64 KiB + 2 x (K 32 + V 32) KiB = 192 KiB.
//
// float32 inputs are not on the serving path and keep the first design,
// on the CUDA cores, held to `flash_ref` at 2e-5: one block of 128
// threads per (q tile of 32 rows, head, batch) walking kv tiles of 32
// keys up to the causal frontier, q, k and v tiles in shared memory as
// float32, four threads a query row, each with hd/4 of its accumulator.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// float32 inputs: the CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kBQ = 32;            // query rows per block
constexpr int kBK = 32;            // keys per kv tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }

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

// ---------------------------------------------------------------------------
// bf16 inputs: wgmma, TMA and an mbarrier ring
// ---------------------------------------------------------------------------

constexpr int kConsumers = 2;                     // warpgroups of 64 rows
constexpr int kRows = 64 * kConsumers;            // query rows a block
constexpr int kWgThreads = 128 * (kConsumers + 1); // + the producer
constexpr int kProducerRegs = 24;                   // setmaxnreg: the
constexpr int kConsumerRegs = 240;                  // producer's to them
constexpr int kPTerms = 3;                        // bf16 terms of P
constexpr int kStages = 2;

template <int HD>
struct Tile {
    static constexpr int BN = HD == 256 ? 64 : 128;   // keys a kv tile
    static constexpr int CH = HD < 64 ? HD : 64;      // columns a box
    static constexpr int NCH = HD / CH;               // boxes a row
    static constexpr int ROWB = CH * 2;               // bytes a box row
    // the wgmma descriptor's layout: 1 = 128-byte swizzle, 2 = 64, 3 = 32
    static constexpr int LAYOUT = ROWB == 128 ? 1 : (ROWB == 64 ? 2 : 3);
    static constexpr int Q_BYTES = kRows * HD * 2;
    static constexpr int KV_BYTES = BN * HD * 2;
    // + 1 KiB to align the base to the 1024-byte swizzle atom
    static constexpr int SMEM = Q_BYTES + 2 * kStages * KV_BYTES + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
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

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
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
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle layout
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, int layout) {
    return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32
         | static_cast<uint64_t>(layout) << 62;
}

// D (64 x 64, float32) += A (smem, K-major) * B (smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, float32) += A (smem, K-major) * B (smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 16, float32) += A (registers, bf16) * B (smem, MN-major: the
// transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, float32) += A (registers, bf16) * B (smem, MN-major: the
// transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, float32) += A (registers, bf16) * B (smem, MN-major: the
// transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, float32) += A (registers, bf16) * B (smem, MN-major: the
// transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, float32) += A (registers, bf16) * B (smem, MN-major: the
// transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                float* __restrict__ out, float* __restrict__ lse, int S,
                int H, int hkv, float scale_log2) {
    using T = Tile<HD>;
    constexpr int BN = T::BN, CH = T::CH, NCH = T::NCH, ROWB = T::ROWB;
    extern __shared__ uint8_t smem_raw[];
    // q full; K full, V full and empty per stage
    __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];
    const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t s_kv = s_q + T::Q_BYTES;          // stage st: K, then V
    const uint32_t bar_q = smem_u32(&bars[0]);
    const uint32_t bar_k = smem_u32(&bars[1]);        // + 8 * stage
    const uint32_t bar_v = smem_u32(&bars[1 + kStages]);
    const uint32_t bar_e = smem_u32(&bars[1 + 2 * kStages]);

    const int h = blockIdx.x, b = blockIdx.y;
    const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;   // heavy first
    const int kvh = h / (H / hkv);
    const int n_kv = (min(q0 + kRows, S) + BN - 1) / BN;   // causal frontier
    const int tid = threadIdx.x;

    if (tid == 0) {
        mbar_init(bar_q, 1);
        for (int st = 0; st < kStages; ++st) {
            mbar_init(bar_k + 8 * st, 1);
            mbar_init(bar_v + 8 * st, 1);
            mbar_init(bar_e + 8 * st, 4 * kConsumers);   // one a warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // one branch a role, never rejoined, so that setmaxnreg holds
    if (tid >= 128 * kConsumers) {
        // the producer warpgroup gives registers to the consumers; one
        // thread issues every load
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     :: "n"(kProducerRegs));
        if (tid == 128 * kConsumers) {
            mbar_expect_tx(bar_q, T::Q_BYTES);
            for (int c = 0; c < NCH; ++c)
                tma_load(s_q + c * kRows * ROWB, &tq, bar_q, c * CH, h, q0, b);
            for (int j = 0; j < n_kv; ++j) {
                const int st = j % kStages;
                const uint32_t k_dst = s_kv + st * 2 * T::KV_BYTES;
                const uint32_t v_dst = k_dst + T::KV_BYTES;
                // a fresh stage passes (parity 1); then wait for its release
                mbar_wait(bar_e + 8 * st, ((j / kStages) & 1) ^ 1);
                mbar_expect_tx(bar_k + 8 * st, T::KV_BYTES);
                for (int c = 0; c < NCH; ++c)
                    tma_load(k_dst + c * BN * ROWB, &tk, bar_k + 8 * st,
                             c * CH, kvh, j * BN, b);
                mbar_expect_tx(bar_v + 8 * st, T::KV_BYTES);
                for (int c = 0; c < NCH; ++c)
                    tma_load(v_dst + c * BN * ROWB, &tv, bar_v + 8 * st,
                             c * CH, kvh, j * BN, b);
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                     :: "n"(kConsumerRegs));
        // a consumer warpgroup: 64 query rows
        const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
        const int qw0 = q0 + 64 * wg;
        // this thread's two rows of the accumulator fragments
        const int row0 = qw0 + 16 * warp + (lane >> 2), row1 = row0 + 8;
        const int col = 2 * (lane & 3);
        float o[HD / 2];
    #pragma unroll
        for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
        float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
        const uint32_t q_wg = s_q + 64 * wg * ROWB;

        mbar_wait(bar_q, 0);
        for (int j = 0; j < n_kv; ++j) {
            const int st = j % kStages;
            const uint32_t ph = (j / kStages) & 1;
            const uint32_t k_src = s_kv + st * 2 * T::KV_BYTES;
            const uint32_t v_src = k_src + T::KV_BYTES;
            const int k0 = j * BN;
            // a tile with no key <= this warpgroup's last row adds nothing; a
            // live tile has key k0 <= every row of the warpgroup (k0 and qw0
            // are multiples of 64, and of 128 when BN is), so every row's max
            // is finite after it
            const bool live = k0 <= qw0 + 63;
            // P's fragments, its three bf16 terms
            uint32_t pt[kPTerms][BN / 16][4];
            mbar_wait(bar_k + 8 * st, ph);
            if (live) {
                float s[BN / 2];
    #pragma unroll
                for (int i = 0; i < BN / 2; ++i) s[i] = 0.0f;
                fence_regs(s);
                wgmma_fence();
    #pragma unroll
                for (int kk = 0; kk < HD / 16; ++kk) {
                    const int c = kk * 16 / CH;
                    const int off = (kk * 16 % CH) * 2;
                    wgmma_ss(s,
                             desc(q_wg + c * kRows * ROWB + off, 16, 8 * ROWB,
                                  T::LAYOUT),
                             desc(k_src + c * BN * ROWB + off, 16, 8 * ROWB,
                                  T::LAYOUT),
                             kk > 0);
                }
                wgmma_commit();
                wgmma_wait_all();
                fence_regs(s);

                // scale to log2 units; the causal mask on the diagonal tile
                const bool diag = k0 + BN - 1 > qw0;
                float mx0 = m0, mx1 = m1;
    #pragma unroll
                for (int i = 0; i < BN / 8; ++i) {
                    const int key = k0 + 8 * i + col;
    #pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        float x = s[4 * i + e] * scale_log2;
                        if (diag && key + (e & 1) > (e < 2 ? row0 : row1))
                            x = -INFINITY;
                        s[4 * i + e] = x;
                    }
                    mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
                    mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
                }
                mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
                mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
                mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
                mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
                const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
                m0 = mx0;
                m1 = mx1;
                float ls0 = 0.0f, ls1 = 0.0f;
    #pragma unroll
                for (int i = 0; i < BN / 8; ++i) {
                    s[4 * i] = exp2f(s[4 * i] - m0);
                    s[4 * i + 1] = exp2f(s[4 * i + 1] - m0);
                    s[4 * i + 2] = exp2f(s[4 * i + 2] - m1);
                    s[4 * i + 3] = exp2f(s[4 * i + 3] - m1);
                    ls0 += s[4 * i] + s[4 * i + 1];
                    ls1 += s[4 * i + 2] + s[4 * i + 3];
                }
                // a quarter of the row each; summed at the end
                l0 = l0 * c0 + ls0;
                l1 = l1 * c1 + ls1;
    #pragma unroll
                for (int i = 0; i < HD / 8; ++i) {
                    o[4 * i] *= c0;
                    o[4 * i + 1] *= c0;
                    o[4 * i + 2] *= c1;
                    o[4 * i + 3] *= c1;
                }
                // the S fragments of two n8 blocks are the A fragment of one
                // k16 step: rows row0/row1, keys col, col + 1 and col + 8, + 9
    #pragma unroll
                for (int kk = 0; kk < BN / 16; ++kk) {
    #pragma unroll
                    for (int r = 0; r < 4; ++r) {
                        float x0 = s[8 * kk + 2 * r];
                        float x1 = s[8 * kk + 2 * r + 1];
    #pragma unroll
                        for (int t = 0; t < kPTerms; ++t) {
                            const __nv_bfloat162 h =
                                __floats2bfloat162_rn(x0, x1);
                            const float2 hf = __bfloat1622float2(h);
                            pt[t][kk][r] =
                                *reinterpret_cast<const uint32_t*>(&h);
                            // exact in float32: h is x rounded to nearest
                            x0 -= hf.x;
                            x1 -= hf.y;
                        }
                    }
                }
            }
            mbar_wait(bar_v + 8 * st, ph);
            if (live) {
                fence_regs(o);
                wgmma_fence();
    #pragma unroll
                for (int kk = 0; kk < BN / 16; ++kk) {
                    const uint64_t dv = desc(v_src + kk * 16 * ROWB,
                                             BN * ROWB, 8 * ROWB, T::LAYOUT);
    #pragma unroll
                    for (int t = 0; t < kPTerms; ++t)
                        wgmma_rs(o, pt[t][kk], dv);
                }
                wgmma_commit();
                wgmma_wait_all();
                fence_regs(o);
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(bar_e + 8 * st);
        }

        l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
        l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
        const float ln2 = 0.6931471805599453f;
        const long long head = static_cast<long long>(b) * H + h;
    #pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int row = half ? row1 : row0;
            if (row >= S) continue;
            const float l_safe = fmaxf(half ? l1 : l0, 1e-30f);
            float* dst = out + (head * S + row) * HD + col;
    #pragma unroll
            for (int i = 0; i < HD / 8; ++i) {
                float2 v;
                v.x = o[4 * i + 2 * half] / l_safe;
                v.y = o[4 * i + 2 * half + 1] / l_safe;
                *reinterpret_cast<float2*>(dst + 8 * i) = v;
            }
            if ((lane & 3) == 0)
                lse[head * S + row] = (half ? m1 : m0) * ln2 + logf(l_safe);
        }
    }
}

// cuTensorMapEncodeTiled, through the runtime's entry-point query: the
// library links no driver stub
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (e != cudaSuccess || found != cudaDriverEntryPointSuccess)
            return nullptr;
        fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// a (hd, heads, S, B) bf16 tensor read in boxes of (ch, 1, rows, 1), rows
// past S filled with zeros, swizzled to the box row's width
bool make_map(CUtensorMap* map, const void* ptr, int hd, int heads, int S,
              int B, int rows, int ch) {
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                                static_cast<cuuint64_t>(heads),
                                static_cast<cuuint64_t>(S),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t row = 2ull * hd;
    const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(ch), 1,
                               static_cast<cuuint32_t>(rows), 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUtensorMapSwizzle swizzle =
        ch == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                 : (ch == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                             : CU_TENSOR_MAP_SWIZZLE_32B);
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(ptr), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                void* lse, int B, int S, int H, int hkv, float scale,
                cudaStream_t st) {
    using T = Tile<HD>;
    auto kernel = flash_fwd_wgmma<HD>;
    static bool attr_set = false;            // once per instantiation
    if (!attr_set) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
        if (e != cudaSuccess) return static_cast<int>(e);
        attr_set = true;
    }
    CUtensorMap tq, tk, tv;
    if (!make_map(&tq, q, HD, H, S, B, kRows, T::CH)
        || !make_map(&tk, k, HD, hkv, S, B, T::BN, T::CH)
        || !make_map(&tv, v, HD, hkv, S, B, T::BN, T::CH))
        return -6;
    const dim3 grid(H, B, (S + kRows - 1) / kRows);
    kernel<<<grid, kWgThreads, T::SMEM, st>>>(
        tq, tk, tv, static_cast<float*>(out), static_cast<float*>(lse), S, H,
        hkv, scale * 1.4426950408889634f);
    return static_cast<int>(cudaGetLastError());
}

int dispatch_bf16(int hd, const void* q, const void* k, const void* v,
                  void* out, void* lse, int B, int S, int H, int hkv,
                  float scale, cudaStream_t st) {
    switch (hd) {
        case 16: return launch_bf16<16>(q, k, v, out, lse, B, S, H, hkv, scale, st);
        case 32: return launch_bf16<32>(q, k, v, out, lse, B, S, H, hkv, scale, st);
        case 64: return launch_bf16<64>(q, k, v, out, lse, B, S, H, hkv, scale, st);
        case 128: return launch_bf16<128>(q, k, v, out, lse, B, S, H, hkv, scale, st);
        case 256: return launch_bf16<256>(q, k, v, out, lse, B, S, H, hkv, scale, st);
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
    if (!is_bf16)
        return dispatch_hd<float>(hd, q, k, v, out, lse, B, S, H, hkv, scale,
                                  st);
    // TMA reads from 16-byte aligned addresses
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)
         | reinterpret_cast<uintptr_t>(v)) & 15u)
        return -5;
    return dispatch_bf16(hd, q, k, v, out, lse, B, S, H, hkv, scale, st);
}
