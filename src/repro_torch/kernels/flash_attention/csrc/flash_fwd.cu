// Causal GQA flash-attention forward for sm_90a: the prefill's
// self-attention with positions 0..S-1.
//
// Replaces the TPU kernel `_flash_fwd_kernel` of
// src/repro/kernels/flash_attention/kernel.py:28 (Pallas, `pallas_call`
// at :82; grid (B, H, q blocks, kv blocks), the kv axis sequential with
// (m, l, acc) in VMEM, blocks past the causal frontier skipped, KV head =
// h // g in the index map). Same contract: q (B, S, H, hd), k (B, S, Hkv,
// hd), v (B, S, Hkv, hd_v), bf16 or float32; out (B, H, S, hd_v) float32
// and lse (B, H, S) float32:
//   s = scale * (q . k),  masked to key <= query,
//   online softmax over kv tiles,  out = acc / max(l, 1e-30),
//   lse = m + log(max(l, 1e-30)).
// Unlike the Pallas kernel it takes any S: the ragged edge is masked here,
// and query rows past S are not written.
//
// Bound on this card: operations. The causal half of the two products is
// 2*B*H*S^2*(hd + hd_v)/2 operations against q, k, v in and out, lse back,
// some 300 operations a byte at gemma-2b's prefill (B 4, S 2048, H 8, Hkv
// 1, hd 256): 68.7 GFLOP, 0.0695 ms at the bf16 tensor-core rate. P enters
// its product as three bf16 terms (below), so the tensor cores do
// hd + 3 hd_v units where the function needs hd + hd_v: the least time of
// this arithmetic is 2x the bound at equal widths (0.139 ms at gemma's),
// 1.8x at MLA's 192/128.
//
// bf16 inputs (the serving path) run on the tensor cores:
// - A work item is 128 query rows of one (batch, head). The kernel is
//   persistent: one block an SM (the grid is min(items, SMs)) walks its
//   items, heaviest first (the last q tiles: late rows see the most keys;
//   a block's round r takes item r * grid + its place, the places reversed
//   in odd rounds). A block is two consumer warpgroups of 64 rows each and
//   a producer warpgroup whose registers `setmaxnreg` hands to the
//   consumers (24, the least, and 240 a thread, all that leaves).
// - One producer thread issues TMA loads (`cp.async.bulk.tensor.4d`,
//   tensor maps (hd, heads, S, B) built on the host, rows past S come back
//   as zeros) of each item's q, once both warpgroups have released the
//   last item's (a `q empty` barrier), and of K and V tiles of BN keys
//   into two rings of NS stages each that run on across items, in the
//   order the consumers take them (K_j, then V_{j-1}); each completion is
//   counted on a `full` mbarrier, and the consumers release a K tile as
//   soon as its scores are computed and a V tile once its product is,
//   each on its own `empty` barrier. So an item's q and first tiles load
//   while the consumers still write the last item's out (on an H100 the
//   persistent form ran 2-10% faster than a block an item, the most at
//   train_lm's and arctic's shapes). Tiles past the causal frontier are
//   never loaded. A tile lands as boxes of [rows][64] bf16 with the
//   128-byte swizzle (32 and 64 bytes at hd 16 and 32), the layout
//   `wgmma` reads through a descriptor.
// - S = Q K^T is `wgmma` m64nBNk16 (bf16 in, float32 accumulate), K
//   K-major in shared memory and Q from shared memory too, or, at hd 128
//   and 192, from registers (loaded once by `ldmatrix`: it spares shared
//   memory's bandwidth where S's n is 64). O += P V is m64n(hd_v)k16 with P
//   from registers and V read MN-major through the transpose bit. O stays
//   in registers.
// - The online softmax is float32: scores scaled by log2(e) * scale in the
//   exponent's fused multiply-add, the causal mask on the diagonal tiles
//   only, row max and sum over the four threads of a row by shuffles, 2^x
//   on the special-function unit (`ex2.approx.ftz`: a P under 2^-126, the
//   row's largest being 1, is 0).
// - P reaches the second product in float32, as the TPU kernel and
//   `flash_ref` keep it, as three bf16 terms that sum to it exactly, each
//   an m64n(hd_v)k16 `wgmma` into the same O, each term rounded to
//   nearest (`split3`). Terms cut by truncation (bit masks and byte
//   permutes, no conversion) ran 1-3% faster on an H100 but left out 1.3x
//   further from the float32 plain version (9.8e-7 of max |out| against
//   7.3e-7 at gemma-2b's prefill: every term of the same sign), and
//   gemma-2b's gradient check in training then failed (1.307 of 1.3 on
//   one leaf). One bf16 term (as the flash kernels of PyTorch's SDPA
//   round P) moved llava-next-34b's logits at 48 and 60 layers 1.3-1.5x
//   further from the plain version's than the plain version's own
//   summation-order floor; two terms still left 9x the float32 error.
// - The CUDA-core work (mask, max, 2^x, the sum, O's rescale, the split:
//   some 11 instructions a score) runs beside the tensor cores in two ways.
//   Between the warpgroups, a ping-pong: named barriers 1 and 2 give each
//   warpgroup in turn the right to issue its products, so one's softmax
//   runs while the other's products do. Inside a warpgroup, a turn issues
//   tile t's S = Q K^T and then tile t-1's three P V products, waits for
//   S alone (`wgmma.wait_group 1`), runs tile t's softmax while P V runs,
//   and only then waits for P V, rescales O and splits tile t's P into the
//   registers P V read. Every warpgroup takes n_kv + 1 turns an item, so
//   the barriers stay paired where one warpgroup has a tile fewer. Nothing
//   branches while a product is in flight: ptxas serializes every `wgmma`
//   of a kernel that does (C7518, C7513 in its report), so the turns are
//   peeled (the first, the unmasked, the masked, the last), the mask is
//   selects and the releases predicated instructions. Splitting into a
//   second set of registers while P V reads the first also serializes.
// - Registers: S of tile t (BN/2 float32 a thread), P's terms of tile t-1
//   (3 BN/4) and O (hd_v/2) are live together, so BN is 128 where hd_v
//   is at most 64 (hd 16, 32, 64: 168, 176, 192 of the 240) and 64 above
//   (hd 128 and 192/128: 144, with q's fragments 176 and 192; hd 256:
//   208). ptxas reports no spill in any instantiation.
// - MLA's prefill (deepseek-v2-lite: q and k 192, v 128) has a form of
//   its own, <192, 128>: S at k 192, P V at n 128, O 64 float32 a thread,
//   its own tensor maps, no padding.
// Shared memory (q, then NS stages of K and of V): hd 256 64 + 2 x (32 +
// 32) KiB = 192 KiB; hd 128 32 + 3 x (16 + 16) = 128; 192/128 48 + 3 x
// (24 + 16) = 168; hd 64 16 + 3 x (16 + 16) = 112.
//
// float32 inputs are not on the serving path and keep the first design,
// on the CUDA cores, held to `flash_ref` at 2e-5: one block of 128
// threads per (q tile of 32 rows, head, batch) walking kv tiles of 32
// keys up to the causal frontier, q, k and v tiles in shared memory as
// float32, four threads a query row, each with hd/4 of its accumulator;
// one width for q, k and v.
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
// bf16 inputs: wgmma, TMA, two mbarrier rings and a ping-pong
// ---------------------------------------------------------------------------

constexpr int kConsumers = 2;                      // warpgroups of 64 rows
constexpr int kRows = 64 * kConsumers;             // query rows a block
constexpr int kWgThreads = 128 * (kConsumers + 1); // + the producer
constexpr int kProducerRegs = 24;                  // setmaxnreg: the least,
constexpr int kConsumerRegs = 240;                 // and all that leaves
constexpr int kPTerms = 3;                         // bf16 terms of P

// the wgmma descriptor's layout for a box row of this many bytes: 1 =
// 128-byte swizzle, 2 = 64, 3 = 32
constexpr int layout_of(int row_bytes) {
    return row_bytes == 128 ? 1 : (row_bytes == 64 ? 2 : 3);
}

// HDQ: the width of q and k; HDV: of v and out
template <int HDQ, int HDV>
struct Tile {
    // keys a kv tile: S (BN/2 float32 a thread), P's terms (3 BN/4) and O
    // (HDV/2) are live together
    static constexpr int BN = HDV <= 64 ? 128 : 64;
    static constexpr int NS = HDQ == 256 ? 2 : 3;     // stages a ring
    // S's A operand (the warpgroup's q rows) from registers, loaded once,
    // where they fit beside S, P's terms and O (HDQ/4 a thread: at hd
    // 128 and 192/128); elsewhere from shared memory
    static constexpr bool QREGS = HDQ >= 128 && HDQ <= 192;
    static constexpr int CHQ = HDQ < 64 ? HDQ : 64;   // columns a box
    static constexpr int CHV = HDV < 64 ? HDV : 64;
    static constexpr int NCHQ = HDQ / CHQ, NCHV = HDV / CHV;
    static constexpr int ROWQ = CHQ * 2, ROWV = CHV * 2;  // bytes a box row
    static constexpr int LAYQ = layout_of(ROWQ), LAYV = layout_of(ROWV);
    static constexpr int Q_BYTES = kRows * HDQ * 2;
    static constexpr int K_BYTES = BN * HDQ * 2;
    static constexpr int V_BYTES = BN * HDV * 2;
    // + 1 KiB to align the base to the 1024-byte swizzle atom
    static constexpr int SMEM = Q_BYTES + NS * (K_BYTES + V_BYTES) + 1024;
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

// mbar_arrive where pred holds: a predicated instruction, not a branch
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.u32 p, %1, 0;\n"
                 "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
                 :: "r"(bar), "r"(static_cast<uint32_t>(pred)) : "memory");
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

// returns once at most N of this warpgroup's committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// the same for the registers an asynchronous product reads P's terms from
template <int T, int K>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[T][K][4]) {
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
            for (int i = 0; i < 4; ++i)
                asm volatile("" : "+r"(r[t][k][i]) :: "memory");
}

// named barriers 1 and 2: warpgroup 0's and warpgroup 1's turn to issue
// its products; both consumer warpgroups (256 threads) take part in each
__device__ __forceinline__ void turn_wait(int id) {
    asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void turn_pass(int id) {
    asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// turn_pass where pred holds: a predicated instruction, not a branch
__device__ __forceinline__ void turn_pass_if(int id, bool pred) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.u32 p, %1, 0;\n"
                 "@p bar.arrive %0, 256;\n}\n"
                 :: "r"(id), "r"(static_cast<uint32_t>(pred)) : "memory");
}

// 2^x on the special-function unit; a result under 2^-126 is 0
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// Two float32 scores of one row (columns c and c + 1) as the three bf16x2
// registers of their terms, each rounded to nearest: t1 = bf16(x), t2 =
// bf16(x - t1), t3 = bf16(x - t1 - t2), each difference exact in
// float32. The three sum to x exactly for every float32 x >= 2^-110
// (checked for every such value in [0, 1]); below, t3 falls under bf16's
// subnormals and x loses at most 2^-134.
// tests/test_torch_serve_kernels.py::_bf16_terms is this split on the CPU.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& t1,
                                       uint32_t& t2, uint32_t& t3) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    float2 f = __bfloat1622float2(h);
    t1 = *reinterpret_cast<const uint32_t*>(&h);
    x0 -= f.x;
    x1 -= f.y;
    h = __floats2bfloat162_rn(x0, x1);
    f = __bfloat1622float2(h);
    t2 = *reinterpret_cast<const uint32_t*>(&h);
    x0 -= f.x;
    x1 -= f.y;
    h = __floats2bfloat162_rn(x0, x1);
    t3 = *reinterpret_cast<const uint32_t*>(&h);
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

// D (64 x 64, float32) += A (registers, bf16) * B (smem, K-major)
__device__ __forceinline__ void wgmma_rs_k(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
}

// D (64 x 128, float32) += A (registers, bf16) * B (smem, K-major)
__device__ __forceinline__ void wgmma_rs_k(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
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
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
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

// What a consumer warpgroup's turns read. Every address is one of these
// plus a constant, recomputed where it is used rather than held in a
// register: the turn at hd 256 keeps 208 of its 240 registers for S, P's
// terms and O.
template <int HDQ, int HDV>
struct Ctx {
    using T = Tile<HDQ, HDV>;
    static constexpr int NS = T::NS;
    uint32_t smem;          // q, then the K ring, then the V ring
    uint32_t bars;          // q full, q empty, then the rings' barriers
    int qw0;                // this warpgroup's first row
    float scale_log2;
    int base;               // the block's kv tiles before this item's

    __device__ __forceinline__ int wg() const { return threadIdx.x >> 7; }
    __device__ __forceinline__ uint32_t q_tile() const {
        return smem + 64 * wg() * T::ROWQ;
    }
    // tile t of this item is the block's tile base + t of each ring
    __device__ __forceinline__ uint32_t k_tile(int t) const {
        return smem + T::Q_BYTES + ((base + t) % NS) * T::K_BYTES;
    }
    __device__ __forceinline__ uint32_t v_tile(int t) const {
        return smem + T::Q_BYTES + NS * T::K_BYTES
               + ((base + t) % NS) * T::V_BYTES;
    }
    // ring r (0 K full, 1 K empty, 2 V full, 3 V empty): tile t's barrier
    __device__ __forceinline__ uint32_t bar(int r, int t) const {
        return bars + 8 * (2 + r * NS + (base + t) % NS);
    }
    __device__ __forceinline__ void wait_full(int r, int t) const {
        mbar_wait(bar(r, t), ((base + t) / NS) & 1);
    }
    // the warp's release of tile t's stage on ring r, where pred holds
    __device__ __forceinline__ void release(int r, int t, bool pred) const {
        __syncwarp();
        mbar_arrive_if(bar(r, t), (threadIdx.x & 31) == 0 && pred);
    }
    // named barriers 1 and 2: warpgroup 0's and 1's turn
    __device__ __forceinline__ int mine() const { return 1 + wg(); }
    __device__ __forceinline__ int theirs() const { return 2 - wg(); }
    // this thread's first row of the accumulator fragments (the second is
    // 8 below) and its first column
    __device__ __forceinline__ int row0() const {
        return qw0 + 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
    }
    __device__ __forceinline__ int col() const {
        return 2 * (threadIdx.x & 3);
    }
};

// the online softmax's running max (log2 units) and sum of this thread's
// two rows (the sum over a quarter of each row)
struct Rows {
    float m0, m1, l0, l1;
};

constexpr int kRingKF = 0, kRingKE = 1, kRingVF = 2, kRingVE = 3;

// The warpgroup's q rows as the A fragments of S's k16 steps (QREGS):
// ldmatrix from the 128-byte swizzled tile (HDQ >= 64), where the 16-byte
// chunk j of row r lies at chunk j ^ (r % 8)
template <int HDQ, int HDV>
__device__ __forceinline__ void load_q(uint32_t (&qf)[HDQ / 16][4],
                                       const Ctx<HDQ, HDV>& c) {
    using T = Tile<HDQ, HDV>;
    const int lane = threadIdx.x & 31, mi = lane >> 3;
    // this lane's row of matrix mi: rows 0-7 (mi 0, 2) or 8-15 (1, 3) of
    // the warp's 16; columns 0-7 (mi 0, 1) or 8-15 (2, 3) of the step
    const int r = 64 * c.wg() + 16 * ((threadIdx.x >> 5) & 3)
                  + 8 * (mi & 1) + (lane & 7);
#pragma unroll
    for (int kk = 0; kk < HDQ / 16; ++kk) {
        const int k = kk * 16 + 8 * (mi >> 1);
        const uint32_t addr = c.smem + (k / 64) * kRows * T::ROWQ
                              + r * T::ROWQ + ((((k % 64) / 8) ^ (r & 7)) << 4);
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
            "[%4];\n"
            : "=r"(qf[kk][0]), "=r"(qf[kk][1]), "=r"(qf[kk][2]),
              "=r"(qf[kk][3])
            : "r"(addr) : "memory");
    }
}

// S = Q K_t^T, one committed group
template <int HDQ, int HDV>
__device__ __forceinline__ void issue_s(float (&s)[Tile<HDQ, HDV>::BN / 2],
                                        const uint32_t (&qf)[HDQ / 16][4],
                                        const Ctx<HDQ, HDV>& c, int t) {
    using T = Tile<HDQ, HDV>;
    const uint32_t k_src = c.k_tile(t);
    uint32_t q_src = c.q_tile();
    // computed again at every turn: the compiler would hold Q's
    // descriptors, which no turn changes, in registers
    asm volatile("" : "+r"(q_src));
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDQ / 16; ++kk) {
        const int ch = kk * 16 / T::CHQ;
        const int off = (kk * 16 % T::CHQ) * 2;
        const uint64_t dk = desc(k_src + ch * T::BN * T::ROWQ + off, 16,
                                 8 * T::ROWQ, T::LAYQ);
        if (T::QREGS)
            wgmma_rs_k(s, qf[kk], dk, kk > 0);
        else
            wgmma_ss(s,
                     desc(q_src + ch * kRows * T::ROWQ + off, 16,
                          8 * T::ROWQ, T::LAYQ),
                     dk, kk > 0);
    }
    wgmma_commit();
}

// O += P_t V_t from P's three terms in pt, one committed group
template <int HDQ, int HDV>
__device__ __forceinline__ void issue_pv(
        float (&o)[HDV / 2],
        const uint32_t (&pt)[kPTerms][Tile<HDQ, HDV>::BN / 16][4],
        const Ctx<HDQ, HDV>& c, int t) {
    using T = Tile<HDQ, HDV>;
    const uint32_t v_src = c.v_tile(t);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::BN / 16; ++kk) {
        const uint64_t dv = desc(v_src + kk * 16 * T::ROWV, T::BN * T::ROWV,
                                 8 * T::ROWV, T::LAYV);
#pragma unroll
        for (int r = 0; r < kPTerms; ++r)
            wgmma_rs(o, pt[r][kk], dv);
    }
    wgmma_commit();
}

// tile t's online softmax in place (s becomes P); O's corrections in c0
// and c1. MASKED: the causal mask (a tile with a key past a row of the
// warpgroup), as selects
template <int HDQ, int HDV, bool MASKED>
__device__ __forceinline__ void softmax(float (&s)[Tile<HDQ, HDV>::BN / 2],
                                        const Ctx<HDQ, HDV>& c, int t,
                                        Rows& st, float& c0, float& c1) {
    constexpr int BN = Tile<HDQ, HDV>::BN;
    if (MASKED) {
        const int row0 = c.row0(), row1 = row0 + 8;
        const int k0 = t * BN + c.col();
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
            const int key = k0 + 8 * i;
            s[4 * i] = key > row0 ? -INFINITY : s[4 * i];
            s[4 * i + 1] = key + 1 > row0 ? -INFINITY : s[4 * i + 1];
            s[4 * i + 2] = key > row1 ? -INFINITY : s[4 * i + 2];
            s[4 * i + 3] = key + 1 > row1 ? -INFINITY : s[4 * i + 3];
        }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // in log2 units; scale_log2 > 0, so the scaled max is the max of the
    // scaled scores
    const float n0 = fmaxf(st.m0, mx0 * c.scale_log2);
    const float n1 = fmaxf(st.m1, mx1 * c.scale_log2);
    c0 = ex2(st.m0 - n0);                             // 0 at tile 0
    c1 = ex2(st.m1 - n1);
    st.m0 = n0;
    st.m1 = n1;
    float la = 0.0f, lb = 0.0f, lc = 0.0f, ld = 0.0f;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
        s[4 * i] = ex2(fmaf(s[4 * i], c.scale_log2, -n0));
        s[4 * i + 1] = ex2(fmaf(s[4 * i + 1], c.scale_log2, -n0));
        s[4 * i + 2] = ex2(fmaf(s[4 * i + 2], c.scale_log2, -n1));
        s[4 * i + 3] = ex2(fmaf(s[4 * i + 3], c.scale_log2, -n1));
        la += s[4 * i];
        lb += s[4 * i + 1];
        lc += s[4 * i + 2];
        ld += s[4 * i + 3];
    }
    st.l0 = st.l0 * c0 + (la + lb);
    st.l1 = st.l1 * c1 + (lc + ld);
}

// P's three terms: the S fragments of two n8 blocks are the A fragment of
// one k16 step (rows row0/row1, keys col, col + 1 and col + 8, + 9)
template <int BN>
__device__ __forceinline__ void split(const float (&s)[BN / 2],
                                      uint32_t (&pt)[kPTerms][BN / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
            split3(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], pt[0][kk][r],
                   pt[1][kk][r], pt[2][kk][r]);
    }
}

// turn t of 1 .. n_w - 1: S of tile t, then P V of tile t - 1; tile t's
// softmax runs while P V does. Nothing branches while a product is in
// flight (ptxas would serialize every wgmma of the kernel): the turns
// are peeled, the mask is selects and the releases are predicated
template <int HDQ, int HDV, bool MASKED>
__device__ __forceinline__ void turn(
        float (&o)[HDV / 2],
        uint32_t (&pt)[kPTerms][Tile<HDQ, HDV>::BN / 16][4], Rows& st,
        const uint32_t (&qf)[HDQ / 16][4], const Ctx<HDQ, HDV>& c, int t) {
    float s[Tile<HDQ, HDV>::BN / 2];
    c.wait_full(kRingKF, t);
    c.wait_full(kRingVF, t - 1);
    turn_wait(c.mine());
    issue_s<HDQ, HDV>(s, qf, c, t);
    issue_pv<HDQ, HDV>(o, pt, c, t - 1);
    turn_pass(c.theirs());                            // a last turn follows
    wgmma_wait<1>();                                  // S alone
    fence_regs(s);
    c.release(kRingKE, t, true);
    float c0, c1;
    softmax<HDQ, HDV, MASKED>(s, c, t, st, c0, c1);
    wgmma_wait<0>();                                  // P V of tile t - 1
    fence_regs(o);
    fence_regs(pt);
    c.release(kRingVE, t - 1, true);
#pragma unroll
    for (int i = 0; i < HDV / 8; ++i) {
        o[4 * i] *= c0;
        o[4 * i + 1] *= c0;
        o[4 * i + 2] *= c1;
        o[4 * i + 3] *= c1;
    }
    split<Tile<HDQ, HDV>::BN>(s, pt);
}

// A block's work items, heaviest first: the last q tiles, then the head
// fastest, then the batch. Round r of a block takes item r * grid + its
// place, the places reversed in odd rounds, so that a block that took a
// heavy item takes a lighter one next
struct Item {
    int h, b, q0;
};

__device__ __forceinline__ int item_index(int r) {
    return r * gridDim.x
           + ((r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

__device__ __forceinline__ Item item_of(int w, int H, int B, int nq) {
    const int hb = H * B, rest = w % hb;
    return {rest % H, rest / H, (nq - 1 - w / hb) * kRows};
}

// Persistent: one block an SM walks its work items; the producer loads an
// item's q and first tiles while the consumers write the last item's out
template <int HDQ, int HDV>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                float* __restrict__ out, float* __restrict__ lse, int B,
                int S, int H, int hkv, float scale_log2) {
    using T = Tile<HDQ, HDV>;
    constexpr int BN = T::BN, NS = T::NS;
    extern __shared__ uint8_t smem_raw[];
    // q full, q empty; a stage each: K full, K empty, V full, V empty
    __shared__ __align__(8) uint64_t bars[2 + 4 * NS];
    const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t s_k = s_q + T::Q_BYTES;        // + stage * K_BYTES
    const uint32_t s_v = s_k + NS * T::K_BYTES;   // + stage * V_BYTES
    const uint32_t bar_q = smem_u32(&bars[0]);
    const uint32_t bar_qe = bar_q + 8;
    const uint32_t bar_kf = bar_q + 16;           // + 8 * stage
    const uint32_t bar_ke = bar_kf + 8 * NS;
    const uint32_t bar_vf = bar_ke + 8 * NS;
    const uint32_t bar_ve = bar_vf + 8 * NS;

    const int nq = (S + kRows - 1) / kRows;
    const int n_items = nq * H * B;
    const int tid = threadIdx.x;

    if (tid == 0) {
        mbar_init(bar_q, 1);
        mbar_init(bar_qe, 4 * kConsumers);            // one a warp
        for (int st = 0; st < NS; ++st) {
            mbar_init(bar_kf + 8 * st, 1);
            mbar_init(bar_ke + 8 * st, 4 * kConsumers);
            mbar_init(bar_vf + 8 * st, 1);
            mbar_init(bar_ve + 8 * st, 4 * kConsumers);
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
            int j0 = 0;                       // the block's kv tiles so far
            for (int r = 0;; ++r) {
                const int w = item_index(r);
                if (w >= n_items) break;
                const Item it = item_of(w, H, B, nq);
                const int kvh = it.h / (H / hkv);
                const int n_kv = (min(it.q0 + kRows, S) + BN - 1) / BN;
                // the q buffer, once both warpgroups are done with the
                // last item's (a fresh barrier passes parity 1)
                mbar_wait(bar_qe, (r & 1) ^ 1);
                mbar_expect_tx(bar_q, T::Q_BYTES);
                for (int c = 0; c < T::NCHQ; ++c)
                    tma_load(s_q + c * kRows * T::ROWQ, &tq, bar_q,
                             c * T::CHQ, it.h, it.q0, it.b);
                // in the order the consumers take them: K_j, then V_{j-1};
                // a fresh stage passes its empty barrier (parity 1), a
                // used one once both warpgroups have released it
                for (int j = 0; j <= n_kv; ++j) {
                    if (j < n_kv) {
                        const int g = j0 + j, st = g % NS;
                        const uint32_t dst = s_k + st * T::K_BYTES;
                        mbar_wait(bar_ke + 8 * st, ((g / NS) & 1) ^ 1);
                        mbar_expect_tx(bar_kf + 8 * st, T::K_BYTES);
                        for (int c = 0; c < T::NCHQ; ++c)
                            tma_load(dst + c * BN * T::ROWQ, &tk,
                                     bar_kf + 8 * st, c * T::CHQ, kvh,
                                     j * BN, it.b);
                    }
                    if (j > 0) {
                        const int g = j0 + j - 1, st = g % NS;
                        const uint32_t dst = s_v + st * T::V_BYTES;
                        mbar_wait(bar_ve + 8 * st, ((g / NS) & 1) ^ 1);
                        mbar_expect_tx(bar_vf + 8 * st, T::V_BYTES);
                        for (int c = 0; c < T::NCHV; ++c)
                            tma_load(dst + c * BN * T::ROWV, &tv,
                                     bar_vf + 8 * st, c * T::CHV, kvh,
                                     (j - 1) * BN, it.b);
                    }
                }
                j0 += n_kv;
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                     :: "n"(kConsumerRegs));
        // a consumer warpgroup: 64 query rows of each item
        const int wg = tid >> 7;
        int j0 = 0;                           // the block's kv tiles so far
        if (wg == 1) turn_pass(1);                    // warpgroup 0 first
        for (int r = 0;; ++r) {
            const int w = item_index(r);
            if (w >= n_items) break;
            const int q0 = item_of(w, H, B, nq).q0;
            const int n_kv = (min(q0 + kRows, S) + BN - 1) / BN;
            const Ctx<HDQ, HDV> c = {s_q, bar_q, q0 + 64 * wg, scale_log2,
                                     j0};
            // the kv tiles with a key <= this warpgroup's last row (a tile
            // fewer than the item's n_kv for warpgroup 0 where BN is 64),
            // and the first with a key past its first row: the tiles from
            // there on are masked. Tile 0's first key is <= every row, so
            // every row's max is finite after it
            const int n_w = (min(c.qw0 + 64, S) + BN - 1) / BN;
            const int t_m = (c.qw0 + 1) / BN;
            float o[HDV / 2];
    #pragma unroll
            for (int i = 0; i < HDV / 2; ++i) o[i] = 0.0f;
            Rows st = {-INFINITY, -INFINITY, 0.0f, 0.0f};
            // P's fragments of the tile whose P V is next, its three terms
            uint32_t pt[kPTerms][BN / 16][4];
            uint32_t qf[HDQ / 16][4];                 // where QREGS

            mbar_wait(bar_q, r & 1);
            if (T::QREGS) load_q<HDQ, HDV>(qf, c);
            {   // turn 0: S of tile 0 alone (masked: it may hold the
                // diagonal)
                float s[BN / 2];
                c.wait_full(kRingKF, 0);
                turn_wait(c.mine());
                issue_s<HDQ, HDV>(s, qf, c, 0);
                turn_pass(c.theirs());                // n_kv >= 1 follow
                wgmma_wait<0>();
                fence_regs(s);
                c.release(kRingKE, 0, true);
                float c0, c1;
                softmax<HDQ, HDV, true>(s, c, 0, st, c0, c1);
                split<BN>(s, pt);
            }
            const int t_mid = max(1, min(t_m, n_w));
            for (int t = 1; t < t_mid; ++t)
                turn<HDQ, HDV, false>(o, pt, st, qf, c, t);
            for (int t = t_mid; t < n_w; ++t)
                turn<HDQ, HDV, true>(o, pt, st, qf, c, t);
            {   // turn n_w: P V of the last live tile; q is free. The
                // block's last turn of warpgroup 1 (its n_w is n_kv)
                // passes none on
                const int t = n_w;
                c.wait_full(kRingVF, t - 1);
                turn_wait(c.mine());
                issue_pv<HDQ, HDV>(o, pt, c, t - 1);
                turn_pass_if(c.theirs(),
                             wg == 0 || item_index(r + 1) < n_items);
                __syncwarp();
                mbar_arrive_if(bar_qe, (tid & 31) == 0);
                c.release(kRingKE, t, t < n_kv);      // a tile with no key
                wgmma_wait<0>();                      // for these rows
                fence_regs(o);
                c.release(kRingVE, t - 1, true);
            }
            // warpgroup 0's turns past its last live tile: the other's
            // turns go on; the tiles are released unread
            for (int t = n_w + 1; t <= n_kv; ++t) {
                turn_wait(c.mine());
                turn_pass(c.theirs());
                c.release(kRingKE, t, t < n_kv);
                c.release(kRingVE, t - 1, true);
            }
            j0 += n_kv;

            // the item's head and batch, computed again rather than held
            // in registers through the turns
            int rr = r;
            asm volatile("" : "+r"(rr));
            const Item it = item_of(item_index(rr), H, B, nq);
            float l0 = st.l0, l1 = st.l1;
            l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
            l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
            l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
            l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
            const float ln2 = 0.6931471805599453f;
            const long long head = static_cast<long long>(it.b) * H + it.h;
            const int row0 = c.row0(), col = c.col();
    #pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = row0 + 8 * half;
                if (row >= S) continue;
                const float l_safe = fmaxf(half ? l1 : l0, 1e-30f);
                float* dst = out + (head * S + row) * HDV + col;
    #pragma unroll
                for (int i = 0; i < HDV / 8; ++i) {
                    float2 v;
                    v.x = o[4 * i + 2 * half] / l_safe;
                    v.y = o[4 * i + 2 * half + 1] / l_safe;
                    *reinterpret_cast<float2*>(dst + 8 * i) = v;
                }
                if (col == 0)
                    lse[head * S + row] = (half ? st.m1 : st.m0) * ln2
                                          + logf(l_safe);
            }
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

template <int HDQ, int HDV>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                void* lse, int B, int S, int H, int hkv, float scale,
                cudaStream_t st) {
    using T = Tile<HDQ, HDV>;
    auto kernel = flash_fwd_wgmma<HDQ, HDV>;
    static bool attr_set = false;            // once per instantiation
    if (!attr_set) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
        if (e != cudaSuccess) return static_cast<int>(e);
        attr_set = true;
    }
    CUtensorMap tq, tk, tv;
    if (!make_map(&tq, q, HDQ, H, S, B, kRows, T::CHQ)
        || !make_map(&tk, k, HDQ, hkv, S, B, T::BN, T::CHQ)
        || !make_map(&tv, v, HDV, hkv, S, B, T::BN, T::CHV))
        return -6;
    const long long items =
        static_cast<long long>((S + kRows - 1) / kRows) * H * B;
    if (items >= (1LL << 31)) return -4;
    static int sms = 0;                      // one block an SM
    if (sms == 0) {
        int dev = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int grid = static_cast<int>(items < sms ? items : sms);
    kernel<<<grid, kWgThreads, T::SMEM, st>>>(
        tq, tk, tv, static_cast<float*>(out), static_cast<float*>(lse), B, S,
        H, hkv, scale * 1.4426950408889634f);
    return static_cast<int>(cudaGetLastError());
}

int dispatch_bf16(int hd, int hd_v, const void* q, const void* k,
                  const void* v, void* out, void* lse, int B, int S, int H,
                  int hkv, float scale, cudaStream_t st) {
    // MLA's prefill: q and k 192 wide, v 128
    if (hd == 192 && hd_v == 128)
        return launch_bf16<192, 128>(q, k, v, out, lse, B, S, H, hkv, scale,
                                     st);
    if (hd_v != hd) return -2;
    switch (hd) {
        case 16: return launch_bf16<16, 16>(q, k, v, out, lse, B, S, H, hkv, scale, st);
        case 32: return launch_bf16<32, 32>(q, k, v, out, lse, B, S, H, hkv, scale, st);
        case 64: return launch_bf16<64, 64>(q, k, v, out, lse, B, S, H, hkv, scale, st);
        case 128: return launch_bf16<128, 128>(q, k, v, out, lse, B, S, H, hkv, scale, st);
        case 256: return launch_bf16<256, 256>(q, k, v, out, lse, B, S, H, hkv, scale, st);
        default: return -2;
    }
}

}  // namespace

// q (B, S, H, hd), k (B, S, Hkv, hd), v (B, S, Hkv, hd_v): bf16 (is_bf16)
// at hd = hd_v in 16, 32, 64, 128, 256 or at hd 192, hd_v 128; float32 at
// hd = hd_v in 16, 32, 64, 128, 256. Returns 0, or -2 (a width it has no
// form for), -3 (shapes), -4 (a grid too large), -5 (bf16 pointers not
// 16-byte aligned), -6 (a tensor map refused), or cudaGetLastError.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         int is_bf16, void* out, void* lse, int B, int S,
                         int H, int hkv, int hd, int hd_v, float scale,
                         void* stream) {
    if (B < 1 || S < 1 || hkv < 1 || H % hkv != 0) return -3;
    if (B > 65535 || H > 65535) return -4;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (!is_bf16) {
        if (hd_v != hd) return -2;
        return dispatch_hd<float>(hd, q, k, v, out, lse, B, S, H, hkv, scale,
                                  st);
    }
    // TMA reads from 16-byte aligned addresses
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)
         | reinterpret_cast<uintptr_t>(v)) & 15u)
        return -5;
    return dispatch_bf16(hd, hd_v, q, k, v, out, lse, B, S, H, hkv, scale,
                         st);
}
