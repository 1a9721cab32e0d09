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
// Shared by both forms:
// - Two passes and no float atomics, so that two runs give the same
//   bits: a dK/dV pass walks the query tiles on and after its keys'
//   diagonal, recomputes S^T and dP^T and accumulates dV and dK in
//   registers; a dQ pass walks the kv tiles up to its rows' diagonal and
//   accumulates dQ. A prologue kernel computes delta and writes dout as
//   its bf16 terms (below); an epilogue sums the dK/dV pass's float32
//   per-head partials over the group in a fixed order (at Hkv 1 one
//   block a KV head would leave most of the 132 SMs idle). Both passes
//   launch the heaviest tiles first. The wgmma form's dK/dV blocks sum
//   their KV head's group themselves, in order, and write dk and dv
//   with no partials and no epilogue, where the grid still gives each SM
//   two blocks or the group is one head (train_lm's and MLA's shapes;
//   not gemma-2b's, Hkv 1).
// - q, k and v are bf16 and enter the products as they are. The float32
//   operands (P, dS and dout) enter as `terms` bf16 terms (t1 = bf16(x),
//   t2 = bf16(x - t1), t3 = bf16(x - t1 - t2), each difference exact in
//   float32; three sum to x exactly), as flash_fwd.cu splits P; a product
//   of two split operands keeps the term pairs (i, j) with i + j < terms.
//   When no value of dout has a low term (dout is bf16-exact when the
//   model runs in bf16: the prologue raises a flag otherwise), only its
//   first term is read and multiplied.
//
// hd 64, 128 and 256 (every training path's width): wgmma, TMA and an
// mbarrier ring, as flash_fwd.cu's bf16 form.
// - A block is two consumer warpgroups and a producer warpgroup whose
//   registers `setmaxnreg` hands to the consumers (24 and 240 a thread).
//   One producer thread issues every tile load (`cp.async.bulk.tensor`,
//   tensor maps built on the host, rows past S zeros) into a ring of
//   64-row tiles, each completion counted on a `full` mbarrier; the
//   consumers release a tile on its `empty` barrier. Every tile lands as
//   hd/64 boxes of [64 rows][64] bf16 with the 128-byte swizzle, the
//   layout `wgmma` reads through a descriptor. Tiles past the causal
//   frontier are never loaded; the mask is applied on the diagonal tile
//   only.
// - dK/dV pass, keys as M: S^T = K q^T and dP^T = V dout^T are
//   m64n64k16 with both operands K-major in shared memory; dV += P^T dout
//   and dK += dS^T q take P^T and dS^T from registers, their accumulators
//   packed to bf16 terms (each term one `wgmma` with the same B), and
//   read dout and q MN-major through the transpose bit, so no transposed
//   copy is made. A step is one query tile of 64 rows: the ring carries
//   q and dout's terms (one tile each), a second producer warp a ring of
//   the rows' lse and delta.
//   At hd 64 and 128 a block owns 128 keys, 64 a warpgroup, each with
//   its dV and dK in registers (hd/2 + hd/2 float32 a thread). At hd 256
//   that would be 256 float32 a thread, more than setmaxnreg's 240: a
//   block owns 64 keys, and the two warpgroups split hd, each holding
//   dV and dK for 128 of the 256 columns (64 + 64 float32 a thread) and
//   each computing S^T and dP^T for the block's keys itself (10 units of
//   tensor-core work a launch instead of 8 at one term, no exchange
//   through shared memory). The exchange form (one warpgroup S^T, the
//   other dP^T, P^T's and dS^T's terms through shared memory) needs 48
//   KiB more: beside K, V and a ring of four tiles it does not fit, and a
//   ring of three cannot hold a step of float32 dout (q and three terms).
// - dQ pass, queries as M: a block owns 128 query rows, 64 a warpgroup,
//   q and dout's first term resident; S = q K^T and dP = dout V^T from
//   shared memory, dQ += dS K with dS from registers and K read MN-major.
//   A step is one kv tile of 64 keys: V, then K, through the ring.
// - dout's low terms (float32 dout, the flag set: never in training) run
//   through the same ring as extra tiles of a step, so the bf16-exact
//   path keeps its shared memory: the dK/dV pass takes a step's dout
//   terms as consecutive tiles; the dQ pass, whose rows' first term is
//   resident, streams each further term for each warpgroup after a copy
//   of V, its dP products run as extra k-steps into the same dP.
// - The term counts are constants of the code: TERMS a template argument,
//   and dout's (1, or TERMS with the flag) one branch of the consumers
//   into two bodies: products issued under conditions known only at run
//   time made ptxas inject a fence before each `wgmma` (C7519).
// - Registers a consumer thread at hd 256: dK/dV 128 accumulators + S^T
//   and dP^T 32 + 32 + P^T's terms 48; dQ 128 + 32 + 32 (dS's terms 48
//   once S and dP are spent). P^T's products complete before dS^T's terms
//   are packed, so the two sets of terms are never live together (issuing
//   both before one wait was 5-7% slower at hd 256). ptxas reports at
//   most 60 bytes of spill stores in any of these kernels. The barrier
//   waits spin with no timer: a timeout's state at every wait cost the
//   consumers 0.3-2 KiB of spills.
// - Shared memory (1 KiB of it aligns the swizzle atom):
//   dK/dV pass: K and V (2 x 32 KiB at hd 256, 2 x 2 x 16 KiB at 128,
//   2 x 2 x 8 KiB at 64) + a ring of 4, 8, 8 tiles (32, 16, 8 KiB) + 4 x
//   512 B of lse and delta = 195 KiB, 195 KiB, 99 KiB.
//   dQ pass: q and dout's first term for 128 rows (4 tiles) + a ring of
//   3, 8, 8 tiles = 225 KiB, 193 KiB, 97 KiB.
//
// hd 16 and 32 keep the first design, the mma.sync form (no training
// path runs them): mma.sync m16n8k16 bf16 with float32 accumulators, both
// operands read from shared memory by ldmatrix, every tile by 16-byte
// cp.async copies into two stages, 8 warps a block over 64-key (dK/dV)
// or 64-row (dQ) tiles, P and dS through shared memory as their terms.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int kThreads = 256;      // 8 warps: the prologue, the group sum
                                   // and the mma.sync form
constexpr int kTerms = 3;          // the most bf16 terms of an operand
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the prologue: delta = sum_d dout * out, and dout's first bf16 term
// (plane 0 of (terms, B, H, S, HD)); *lo set when any value has a low
// term. One warp a (batch, head, row)
__global__ void __launch_bounds__(kThreads)
flash_bwd_prep(const float* __restrict__ out, const float* __restrict__ dout,
               long long sb, long long sh, long long ss,
               float* __restrict__ delta, bf16* __restrict__ dterms,
               int* __restrict__ lo, int H, int S, int HD, long long rows) {
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
    float acc = 0.f;
    bool low = false;
    for (int i = lane; i < HD; i += 32) {
        const float x = d[i];
        acc += o[i] * x;
        const bf16 hv = __float2bfloat16_rn(x);
        dt[i] = hv;
        low |= x != __bfloat162float(hv);
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, m);
    if (lane == 0) delta[row] = acc;
    if (__any_sync(0xffffffffu, low) && lane == 0) atomicOr(lo, 1);
}

// dout's low terms, planes 1 .. terms - 1, when the prologue found any
// (a bf16 model's dout has none: its first term alone is read, and this
// kernel returns at once)
__global__ void __launch_bounds__(kThreads)
flash_bwd_low_terms(const float* __restrict__ dout, long long sb,
                    long long sh, long long ss, bf16* __restrict__ dterms,
                    const int* __restrict__ lo, int H, int S, int HD,
                    long long rows, int terms) {
    if (*lo == 0) return;
    const long long plane = rows * HD;
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads
                       + threadIdx.x;
         i < plane; i += static_cast<long long>(gridDim.x) * kThreads) {
        const long long row = i / HD;
        const int s = static_cast<int>(row % S);
        const int h = static_cast<int>((row / S) % H);
        const long long b = row / (static_cast<long long>(S) * H);
        float x = dout[b * sb + h * sh + s * ss + i % HD];
        for (int t = 0; t < terms; ++t) {
            const bf16 hv = __float2bfloat16_rn(x);
            if (t > 0) dterms[t * plane + i] = hv;
            x -= __bfloat162float(hv);          // exact in float32
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

// ---------------------------------------------------------------------------
// hd 64, 128 and 256: wgmma, TMA and an mbarrier ring
// ---------------------------------------------------------------------------

constexpr int kConsumers = 2;                      // warpgroups
constexpr int kWgThreads = 128 * (kConsumers + 1); // + the producer
constexpr int kProducerRegs = 24;                  // setmaxnreg: the
constexpr int kConsumerRegs = 240;                 // producer's to them
constexpr int kLStages = 4;                        // lse / delta ring
constexpr int kBox = 8192;                         // a [64][64] bf16 box

template <int HD>
struct Wg {
    static constexpr int NCH = HD / 64;            // boxes a tile row
    static constexpr int TILE = 64 * HD * 2;       // a 64-row tile
    // dK/dV pass: at hd 256 the warpgroups split hd over the same keys
    static constexpr bool SPLIT = HD == 256;
    static constexpr int BC = SPLIT ? 64 : 128;    // keys a block
    static constexpr int NCOL = SPLIT ? HD / 2 : HD;   // dV, dK columns
    static constexpr int KV_TILES = 2 * (BC / 64);     // K's, then V's
    static constexpr int KV_NS = HD == 256 ? 4 : 8;    // ring tiles
    static constexpr int L_BYTES = kLStages * 2 * 64 * 4;
    static constexpr int KV_SMEM = (KV_TILES + KV_NS) * TILE + L_BYTES + 1024;
    // dQ pass: 128 rows a block, q and dout's first term resident
    static constexpr int DQ_ROWS = 64 * kConsumers;
    static constexpr int DQ_NS = HD == 256 ? 3 : 8;
    static constexpr int DQ_SMEM = (2 * kConsumers + DQ_NS) * TILE + 1024;
    static_assert(KV_SMEM + 256 <= 232448 && DQ_SMEM + 256 <= 232448,
                  "a block's shared memory exceeds the card's 227 KiB");
    static_assert(1 + kTerms <= KV_NS && DQ_NS >= 3,
                  "a step's tiles must fit in the ring");
};

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
// stride byte offsets (16-byte units), the 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32
         | static_cast<uint64_t>(1) << 62;
}

// a 64-row tile as an operand whose K runs along its columns (K-major):
// k-step kk, 16 columns, 32 bytes into a 128-byte swizzled row
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int kk) {
    return desc(tile + (kk >> 2) * kBox + (kk & 3) * 32, 16, 1024);
}

// a 64-row tile as an operand whose K runs along its rows (MN-major, the
// transpose bit): k-step kk, 16 rows; N from column 64 * box0 on
__device__ __forceinline__ uint64_t mndesc(uint32_t tile, int kk, int box0) {
    return desc(tile + box0 * kBox + kk * 16 * 128, kBox, 1024);
}

#define WG_D8(o)                                                              \
    "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),               \
    "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define WG_D32(o) WG_D8(o), WG_D8(o + 8), WG_D8(o + 16), WG_D8(o + 24)

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
        : WG_D32(0)
        : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, float32) += A (registers, bf16) * B (smem, MN-major)
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
        : WG_D32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, float32) += A (registers, bf16) * B (smem, MN-major)
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
        : WG_D32(0), WG_D32(32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, float32) += A (registers, bf16) * B (smem, MN-major)
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
        : WG_D32(0), WG_D32(32), WG_D32(64), WG_D32(96)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WG_D32
#undef WG_D8

// a 64 x 64 float32 accumulator (m64n64 fragments) as the A fragments of
// its 4 k-steps of 16 columns, TERMS bf16 terms: the fragments of two n8
// blocks are one k-step's (rows r and r + 8, columns c, c + 1 and c + 8,
// c + 9), as flash_fwd.cu packs P
template <int TERMS>
__device__ __forceinline__ void split_frags(const float (&x)[32],
                                            uint32_t (&a)[TERMS][4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            float x0 = x[8 * kk + 2 * r], x1 = x[8 * kk + 2 * r + 1];
#pragma unroll
            for (int t = 0; t < TERMS; ++t) {
                const bf162 h = __floats2bfloat162_rn(x0, x1);
                a[t][kk][r] = *reinterpret_cast<const uint32_t*>(&h);
                const float2 f = __bfloat1622float2(h);
                x0 -= f.x;     // exact in float32: h is x rounded to nearest
                x1 -= f.y;
            }
        }
    }
}

template <int N>
using Int = std::integral_constant<int, N>;

// the dK/dV pass, one block a (HPB query heads, batch, BC keys), the key
// tile the slowest grid axis (small tiles walk the most query rows, so
// they start first). hpb 1 of a group of g > 1: float32 partials (B, S,
// H, HD) of dK / scale and dV, which flash_bwd_finish sums over the
// group; hpb = g: the block walks its KV head's g query heads in order
// and writes dk and dv (B, S, Hkv, HD) in bf16 itself. TERMS
// bf16 terms of P^T and dS^T; dout's, NO, is 1 or TERMS (the flag), a
// constant of each consumer body: products issued under a condition
// known only at run time cost registers and fences
template <int HD, int TERMS>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_wg(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, const int* __restrict__ lo,
                  float* __restrict__ dk_part, float* __restrict__ dv_part,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H,
                  int hkv, int B, int hpb, float scale, float scale_log2) {
    using T = Wg<HD>;
    constexpr int NS = T::KV_NS, NCH = T::NCH, TILE = T::TILE;
    constexpr int NA = T::NCOL / 2;          // accumulators a thread
    extern __shared__ uint8_t smem_raw[];
    // K and V full; each ring tile full and empty; each lse stage
    __shared__ __align__(8) uint64_t bars[1 + 2 * NS + 2 * kLStages];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t s_k = (raw + 1023u) & ~1023u;
    const uint32_t s_v = s_k + (T::KV_TILES / 2) * TILE;
    const uint32_t s_ring = s_k + T::KV_TILES * TILE;
    float* lring = reinterpret_cast<float*>(smem_raw + (s_ring - raw)
                                            + NS * TILE);
    const uint32_t bar_kv = smem_u32(&bars[0]);
    const uint32_t bar_f = smem_u32(&bars[1]);              // + 8 * tile
    const uint32_t bar_e = smem_u32(&bars[1 + NS]);
    const uint32_t bar_lf = smem_u32(&bars[1 + 2 * NS]);    // + 8 * stage
    const uint32_t bar_le = smem_u32(&bars[1 + 2 * NS + kLStages]);

    const int h0 = blockIdx.x * hpb, b = blockIdx.y;   // first query head
    const int kv0 = blockIdx.z * T::BC;
    const int kvh = h0 / (H / hkv);
    const int tid = threadIdx.x;
    const int n_o = *lo ? TERMS : 1;         // dout's terms that are read
    // steps: each query head's tiles on and after the keys' diagonal
    const int qt0 = kv0 / 64, n_q = (S + 63) / 64 - qt0, n_st = hpb * n_q;

    if (tid == 0) {
        mbar_init(bar_kv, 1);
        for (int i = 0; i < NS; ++i) {
            mbar_init(bar_f + 8 * i, 1);
            mbar_init(bar_e + 8 * i, 4 * kConsumers);    // one a warp
        }
        for (int i = 0; i < kLStages; ++i) {
            mbar_init(bar_lf + 8 * i, 32);               // one a lane
            mbar_init(bar_le + 8 * i, 4 * kConsumers);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // one branch a role, never rejoined, so that setmaxnreg holds
    if (tid >= 128 * kConsumers) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     :: "n"(kProducerRegs));
        const int ptid = tid - 128 * kConsumers;
        if (ptid == 0) {
            // the block's K and V, then q and dout's terms a query tile
            mbar_expect_tx(bar_kv, T::KV_TILES * TILE);
            for (int t = 0; t < T::KV_TILES / 2; ++t)
                for (int c = 0; c < NCH; ++c) {
                    tma_load(s_k + t * TILE + c * kBox, &tk, bar_kv, c * 64,
                             kvh, kv0 + 64 * t, b);
                    tma_load(s_v + t * TILE + c * kBox, &tv, bar_kv, c * 64,
                             kvh, kv0 + 64 * t, b);
                }
            int n = 0;
            for (int st = 0; st < n_st; ++st) {
                const int h = h0 + st / n_q, q0 = (qt0 + st % n_q) * 64;
                for (int u = -1; u < n_o; ++u, ++n) {
                    const int sl = n % NS;
                    const uint32_t dst = s_ring + sl * TILE;
                    // a fresh tile passes (parity 1); then wait for its
                    // release
                    mbar_wait(bar_e + 8 * sl, ((n / NS) & 1) ^ 1);
                    mbar_expect_tx(bar_f + 8 * sl, TILE);
                    for (int c = 0; c < NCH; ++c) {
                        if (u < 0)
                            tma_load(dst + c * kBox, &tq, bar_f + 8 * sl,
                                     c * 64, h, q0, b);
                        else
                            tma_load(dst + c * kBox, &tdo, bar_f + 8 * sl,
                                     c * 64, q0, h, u * B + b);
                    }
                }
            }
        } else if (ptid >= 32 && ptid < 64) {
            // the query tile's lse (in log2 units) and delta, zeros past S
            const int lane = ptid - 32;
            for (int st = 0; st < n_st; ++st) {
                const int ls = st % kLStages;
                const int q0 = (qt0 + st % n_q) * 64;
                const long long head_row =
                    (static_cast<long long>(b) * H + h0 + st / n_q) * S;
                mbar_wait(bar_le + 8 * ls, ((st / kLStages) & 1) ^ 1);
                float* L = lring + ls * 128;
#pragma unroll
                for (int i = lane; i < 64; i += 32) {
                    const int s = q0 + i;
                    L[i] = s < S ? lse[head_row + s] * kLog2e : 0.f;
                    L[64 + i] = s < S ? delta[head_row + s] : 0.f;
                }
                mbar_arrive(bar_lf + 8 * ls);
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                     :: "n"(kConsumerRegs));
        const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
        // this warpgroup's keys, its K and V tiles, its dV/dK columns
        const int kw0 = kv0 + (T::SPLIT ? 0 : 64 * wg);
        const uint32_t kt = s_k + (T::SPLIT ? 0 : wg * TILE);
        const uint32_t vt = s_v + (T::SPLIT ? 0 : wg * TILE);
        const int box0 = T::SPLIT ? 2 * wg : 0;
        const int kr = 16 * warp + (lane >> 2);   // key rows kr, kr + 8
        const int c2 = 2 * (lane & 3);            // query columns c2, + 1

        auto consume = [=](auto no) {
            constexpr int NO = decltype(no)::value;
            float adv[NA], adk[NA];
#pragma unroll
            for (int i = 0; i < NA; ++i) adv[i] = adk[i] = 0.f;
            mbar_wait(bar_kv, 0);
            int n = 0;
            for (int st = 0; st < n_st; ++st, n += 1 + NO) {
                const int q0 = (qt0 + st % n_q) * 64;
                // a tile with every row before the keys adds nothing; keys
                // and rows are multiples of 64 apart
                const bool live = q0 >= kw0, diag = q0 == kw0;
                const int lst = st % kLStages;
                const uint32_t t_q = s_ring + (n % NS) * TILE;
                uint32_t t_o[NO];
#pragma unroll
                for (int u = 0; u < NO; ++u)
                    t_o[u] = s_ring + ((n + 1 + u) % NS) * TILE;
#pragma unroll
                for (int x = 0; x <= NO; ++x)
                    mbar_wait(bar_f + 8 * ((n + x) % NS), ((n + x) / NS) & 1);
                mbar_wait(bar_lf + 8 * lst, (st / kLStages) & 1);
                if (live) {
                    // S^T = K q^T and dP^T = V dout^T: 64 keys x 64 rows
                    float s[32], dp[32];
#pragma unroll
                    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
                    fence_regs(s);
                    fence_regs(dp);
                    wgmma_fence();
#pragma unroll
                    for (int kk = 0; kk < HD / 16; ++kk)
                        wgmma_ss(s, kdesc(kt, kk), kdesc(t_q, kk), kk > 0);
#pragma unroll
                    for (int u = 0; u < NO; ++u)
#pragma unroll
                        for (int kk = 0; kk < HD / 16; ++kk)
                            wgmma_ss(dp, kdesc(vt, kk), kdesc(t_o[u], kk),
                                     kk > 0 || u > 0);
                    wgmma_commit();
                    wgmma_wait_all();
                    fence_regs(s);
                    fence_regs(dp);

                    // P^T and dS^T in place; the causal mask on the
                    // diagonal tile
                    const float* L = lring + lst * 128;
#pragma unroll
                    for (int i = 0; i < 8; ++i) {
                        const float2 l2 =
                            *reinterpret_cast<const float2*>(L + 8 * i + c2);
                        const float2 dl = *reinterpret_cast<const float2*>(
                            L + 64 + 8 * i + c2);
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int key = kw0 + kr + 8 * (e >> 1);
                            const int row = q0 + 8 * i + c2 + (e & 1);
                            float p = exp2f(fmaf(s[4 * i + e], scale_log2,
                                                 -((e & 1) ? l2.y : l2.x)));
                            if (diag && key > row) p = 0.f;
                            dp[4 * i + e] = p * (dp[4 * i + e]
                                                 - ((e & 1) ? dl.y : dl.x));
                            s[4 * i + e] = p;
                        }
                    }
                    // dV += P^T dout over the pairs (t, u), t + u < TERMS
                    {
                        uint32_t pt[TERMS][4][4];
                        split_frags<TERMS>(s, pt);
                        fence_regs(adv);
                        wgmma_fence();
#pragma unroll
                        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                            for (int t = 0; t < TERMS; ++t)
#pragma unroll
                                for (int u = 0; u < NO; ++u)
                                    if (t + u < TERMS)
                                        wgmma_rs(adv, pt[t][kk],
                                                 mndesc(t_o[u], kk, box0));
                        wgmma_commit();
                        wgmma_wait_all();
                        fence_regs(adv);
                    }
                    // dK += dS^T q
                    {
                        uint32_t dt[TERMS][4][4];
                        split_frags<TERMS>(dp, dt);
                        fence_regs(adk);
                        wgmma_fence();
#pragma unroll
                        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                            for (int t = 0; t < TERMS; ++t)
                                wgmma_rs(adk, dt[t][kk], mndesc(t_q, kk, box0));
                        wgmma_commit();
                        wgmma_wait_all();
                        fence_regs(adk);
                    }
                }
                __syncwarp();
                if (lane == 0) {
#pragma unroll
                    for (int x = 0; x <= NO; ++x)
                        mbar_arrive(bar_e + 8 * ((n + x) % NS));
                    mbar_arrive(bar_le + 8 * lst);
                }
            }

#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int key = kw0 + kr + 8 * half;
                if (key >= S) continue;
                if (hpb < H / hkv) {
                    const long long row =
                        ((static_cast<long long>(b) * S + key) * H + h0) * HD
                        + 64 * box0 + c2;
#pragma unroll
                    for (int i = 0; i < NA / 4; ++i) {
                        *reinterpret_cast<float2*>(dk_part + row + 8 * i) =
                            make_float2(adk[4 * i + 2 * half],
                                        adk[4 * i + 2 * half + 1]);
                        *reinterpret_cast<float2*>(dv_part + row + 8 * i) =
                            make_float2(adv[4 * i + 2 * half],
                                        adv[4 * i + 2 * half + 1]);
                    }
                } else {
                    const long long row =
                        ((static_cast<long long>(b) * S + key) * hkv + kvh)
                        * HD + 64 * box0 + c2;
#pragma unroll
                    for (int i = 0; i < NA / 4; ++i) {
                        *reinterpret_cast<bf162*>(dk + row + 8 * i) =
                            __floats2bfloat162_rn(
                                adk[4 * i + 2 * half] * scale,
                                adk[4 * i + 2 * half + 1] * scale);
                        *reinterpret_cast<bf162*>(dv + row + 8 * i) =
                            __floats2bfloat162_rn(adv[4 * i + 2 * half],
                                                  adv[4 * i + 2 * half + 1]);
                    }
                }
            }
        };
        if constexpr (TERMS == 1) consume(Int<1>());
        else if (n_o == 1) consume(Int<1>());
        else consume(Int<TERMS>());
    }
}

// the dQ pass: dq (B, S, H, HD) in bf16, one block a (head, batch, 128
// query rows), the heaviest (last) rows first; TERMS and NO as above
template <int HD, int TERMS>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wg(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ lo, bf16* __restrict__ dq, int S,
                int H, int hkv, int B, float scale_log2, float scale) {
    using T = Wg<HD>;
    constexpr int NS = T::DQ_NS, NCH = T::NCH, TILE = T::TILE;
    constexpr int NA = HD / 2;               // accumulators a thread
    extern __shared__ uint8_t smem_raw[];
    // q and dout's first term full; each ring tile full and empty
    __shared__ __align__(8) uint64_t bars[1 + 2 * NS];
    const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t s_o = s_q + kConsumers * TILE;
    const uint32_t s_ring = s_o + kConsumers * TILE;
    const uint32_t bar_qo = smem_u32(&bars[0]);
    const uint32_t bar_f = smem_u32(&bars[1]);              // + 8 * tile
    const uint32_t bar_e = smem_u32(&bars[1 + NS]);

    const int h = blockIdx.x, b = blockIdx.y;
    const int q0 = (gridDim.z - 1 - blockIdx.z) * T::DQ_ROWS;  // heavy first
    const int kvh = h / (H / hkv);
    const int tid = threadIdx.x;
    const int n_o = *lo ? TERMS : 1;
    const int n_kv = (min(q0 + T::DQ_ROWS, S) + 63) / 64;  // causal frontier

    if (tid == 0) {
        mbar_init(bar_qo, 1);
        for (int i = 0; i < NS; ++i) {
            mbar_init(bar_f + 8 * i, 1);
            mbar_init(bar_e + 8 * i, 4 * kConsumers);    // one a warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid >= 128 * kConsumers) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     :: "n"(kProducerRegs));
        if (tid == 128 * kConsumers) {
            mbar_expect_tx(bar_qo, 2 * kConsumers * TILE);
            for (int w = 0; w < kConsumers; ++w)
                for (int c = 0; c < NCH; ++c) {
                    tma_load(s_q + w * TILE + c * kBox, &tq, bar_qo, c * 64,
                             h, q0 + 64 * w, b);
                    tma_load(s_o + w * TILE + c * kBox, &tdo, bar_qo, c * 64,
                             q0 + 64 * w, h, b);
                }
            // a step's ring tiles: V; for each further dout term u a copy
            // of V (u > 1) and the term's tile of each warpgroup's rows;
            // then K
            const int per = n_o == 1 ? 2 : 3 * n_o - 2;
            int n = 0;
            for (int j = 0; j < n_kv; ++j) {
                for (int x = 0; x < per; ++x, ++n) {
                    const int sl = n % NS;
                    const uint32_t dst = s_ring + sl * TILE;
                    // the x-th tile: V at 0 and 3, K last, else dout's term
                    // 1 + (x - 1) / 3 for warpgroup (x - 1) % 3
                    const bool is_k = x == per - 1;
                    const bool is_v = x % 3 == 0 && !is_k;
                    mbar_wait(bar_e + 8 * sl, ((n / NS) & 1) ^ 1);
                    mbar_expect_tx(bar_f + 8 * sl, TILE);
                    for (int c = 0; c < NCH; ++c) {
                        if (is_k || is_v)
                            tma_load(dst + c * kBox, is_k ? &tk : &tv,
                                     bar_f + 8 * sl, c * 64, kvh, 64 * j, b);
                        else
                            tma_load(dst + c * kBox, &tdo, bar_f + 8 * sl,
                                     c * 64, q0 + 64 * ((x - 1) % 3), h,
                                     (1 + (x - 1) / 3) * B + b);
                    }
                }
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                     :: "n"(kConsumerRegs));
        const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
        const int qw0 = q0 + 64 * wg;
        const int row0 = qw0 + 16 * warp + (lane >> 2), row1 = row0 + 8;
        const int c2 = 2 * (lane & 3);
        const long long head_row = (static_cast<long long>(b) * H + h) * S;
        const float l0 = row0 < S ? lse[head_row + row0] * kLog2e : 0.f;
        const float l1 = row1 < S ? lse[head_row + row1] * kLog2e : 0.f;
        const float d0 = row0 < S ? delta[head_row + row0] : 0.f;
        const float d1 = row1 < S ? delta[head_row + row1] : 0.f;
        const uint32_t t_qw = s_q + wg * TILE, t_ow = s_o + wg * TILE;
        auto release = [=](int m) {
            __syncwarp();
            if (lane == 0) mbar_arrive(bar_e + 8 * (m % NS));
        };
        auto take = [=](int m) {
            mbar_wait(bar_f + 8 * (m % NS), (m / NS) & 1);
            return s_ring + (m % NS) * TILE;
        };

        auto consume = [=](auto no) {
            constexpr int NO = decltype(no)::value;
            float acc[NA];
#pragma unroll
            for (int i = 0; i < NA; ++i) acc[i] = 0.f;
            mbar_wait(bar_qo, 0);
            int n = 0;
            // dS = P (dP - delta) in dp for the kv tile's keys key0 ..,
            // the causal mask on the diagonal tile, then dQ += dS K
            auto ds_dq = [&](float (&s)[32], float (&dp)[32], int key0,
                             bool diag, uint32_t t_k) {
#pragma unroll
                for (int i = 0; i < 8; ++i) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int key = key0 + 8 * i + c2 + (e & 1);
                        const int row = e < 2 ? row0 : row1;
                        float p = exp2f(fmaf(s[4 * i + e], scale_log2,
                                             -(e < 2 ? l0 : l1)));
                        if (diag && key > row) p = 0.f;
                        dp[4 * i + e] = p * (dp[4 * i + e]
                                             - (e < 2 ? d0 : d1));
                    }
                }
                uint32_t dt[TERMS][4][4];
                split_frags<TERMS>(dp, dt);
                fence_regs(acc);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                    for (int t = 0; t < TERMS; ++t)
                        wgmma_rs(acc, dt[t][kk], mndesc(t_k, kk, 0));
                wgmma_commit();
                wgmma_wait_all();
                fence_regs(acc);
            };
            for (int j = 0; j < n_kv; ++j) {
                const int k0 = 64 * j;
                // a tile with every key after this warpgroup's rows adds
                // nothing; keys and rows are multiples of 64 apart
                const bool live = k0 <= qw0 && qw0 < S, diag = k0 == qw0;
                if constexpr (NO == 1) {
                    const int mv = n++, mk = n++;
                    const uint32_t t_v = take(mv), t_k = take(mk);
                    if (live) {
                        // dP = dout V^T and S = q K^T: 64 rows x 64 keys
                        float s[32], dp[32];
#pragma unroll
                        for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
                        fence_regs(s);
                        fence_regs(dp);
                        wgmma_fence();
#pragma unroll
                        for (int kk = 0; kk < HD / 16; ++kk)
                            wgmma_ss(dp, kdesc(t_ow, kk), kdesc(t_v, kk),
                                     kk > 0);
#pragma unroll
                        for (int kk = 0; kk < HD / 16; ++kk)
                            wgmma_ss(s, kdesc(t_qw, kk), kdesc(t_k, kk),
                                     kk > 0);
                        wgmma_commit();
                        wgmma_wait_all();
                        fence_regs(s);
                        fence_regs(dp);
                        ds_dq(s, dp, k0, diag, t_k);
                    }
                    release(mv);
                    release(mk);
                } else {
                    // dout's low terms: dP = dout V^T over the terms, V
                    // streamed again for each term after the second
                    float s[32], dp[32];
#pragma unroll
                    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
                    int mv = n++;
                    uint32_t t_v = take(mv);
                    if (live) {
                        fence_regs(dp);
                        wgmma_fence();
#pragma unroll
                        for (int kk = 0; kk < HD / 16; ++kk)
                            wgmma_ss(dp, kdesc(t_ow, kk), kdesc(t_v, kk),
                                     kk > 0);
                        wgmma_commit();
                    }
#pragma unroll
                    for (int u = 1; u < NO; ++u) {
                        if (u > 1) {
                            if (live) wgmma_wait_all();
                            release(mv);
                            mv = n++;
                            t_v = take(mv);
                        }
                        for (int w = 0; w < kConsumers; ++w) {
                            const int m = n++;
                            const uint32_t t_e = take(m);
                            if (live && w == wg) {
                                wgmma_fence();
#pragma unroll
                                for (int kk = 0; kk < HD / 16; ++kk)
                                    wgmma_ss(dp, kdesc(t_e, kk),
                                             kdesc(t_v, kk), 1);
                                wgmma_commit();
                                wgmma_wait_all();
                            }
                            release(m);
                        }
                    }
                    // the ring holds 3 tiles at hd 256: the last V is 3
                    // tiles before K, so it is released first
                    if (live) wgmma_wait_all();
                    release(mv);
                    // S = q K^T
                    const int mk = n++;
                    const uint32_t t_k = take(mk);
                    if (live) {
                        fence_regs(s);
                        wgmma_fence();
#pragma unroll
                        for (int kk = 0; kk < HD / 16; ++kk)
                            wgmma_ss(s, kdesc(t_qw, kk), kdesc(t_k, kk),
                                     kk > 0);
                        wgmma_commit();
                        wgmma_wait_all();
                        fence_regs(s);
                        fence_regs(dp);
                        ds_dq(s, dp, k0, diag, t_k);
                    }
                    release(mk);
                }
            }

#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = half ? row1 : row0;
                if (row >= S) continue;
                bf16* dst = dq + ((static_cast<long long>(b) * S + row) * H
                                  + h) * HD + c2;
#pragma unroll
                for (int i = 0; i < NA / 4; ++i)
                    *reinterpret_cast<bf162*>(dst + 8 * i) =
                        __floats2bfloat162_rn(acc[4 * i + 2 * half] * scale,
                                              acc[4 * i + 2 * half + 1]
                                              * scale);
            }
        };
        if constexpr (TERMS == 1) consume(Int<1>());
        else if (n_o == 1) consume(Int<1>());
        else consume(Int<TERMS>());
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

// a contiguous bf16 tensor of dims (d0 = hd, d1, d2, d3), innermost
// first, read in boxes of (64, b1, b2, 1) with the 128-byte swizzle;
// out-of-range rows come back as zeros
bool make_map(CUtensorMap* map, const void* ptr, long long d0, long long d1,
              long long d2, long long d3, int b1, int b2) {
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d0),
                                static_cast<cuuint64_t>(d1),
                                static_cast<cuuint64_t>(d2),
                                static_cast<cuuint64_t>(d3)};
    const cuuint64_t s1 = 2ull * d0;
    const cuuint64_t strides[3] = {s1, s1 * d1, s1 * d1 * d2};
    const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(b1),
                               static_cast<cuuint32_t>(b2), 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(ptr), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// launches both passes; *summed set when the dK/dV pass wrote dk and dv
// itself (no partials to sum)
template <int HD, int TERMS>
int launch_wg(const void* q, const void* k, const void* v, const void* lse,
              const void* delta, const void* dterms, const void* lo, void* dq,
              void* dk, void* dv, void* dk_part, void* dv_part, int B, int S,
              int H, int hkv, float scale, bool* summed, cudaStream_t st) {
    using T = Wg<HD>;
    static bool attr_set = false;            // once per instantiation
    if (!attr_set) {
        cudaError_t e = cudaFuncSetAttribute(
            flash_bwd_dkdv_wg<HD, TERMS>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, T::KV_SMEM);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(
                flash_bwd_dq_wg<HD, TERMS>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, T::DQ_SMEM);
        if (e != cudaSuccess) return static_cast<int>(e);
        attr_set = true;
    }
    // q, k, v as (hd, heads, S, B), boxes of 64 rows of one head; dout's
    // terms as (hd, S, H, TERMS * B)
    CUtensorMap tq, tk, tv, tdo;
    if (!make_map(&tq, q, HD, H, S, B, 1, 64)
        || !make_map(&tk, k, HD, hkv, S, B, 1, 64)
        || !make_map(&tv, v, HD, hkv, S, B, 1, 64)
        || !make_map(&tdo, dterms, HD, S, H,
                     static_cast<long long>(TERMS) * B, 64, 1))
        return -6;
    // a block sums its KV head's group itself where the grid still gives
    // every SM two blocks (or the group is one head); else a block a
    // query head and the group sum after
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int g = H / hkv, n_kt = (S + T::BC - 1) / T::BC;
    const int hpb = g == 1 || static_cast<long long>(B) * hkv * n_kt
                                  >= 2LL * sms ? g : 1;
    *summed = hpb == g;
    const float scale_log2 = scale * kLog2e;
    const float* lf = static_cast<const float*>(lse);
    const float* df = static_cast<const float*>(delta);
    const int* flag = static_cast<const int*>(lo);
    flash_bwd_dkdv_wg<HD, TERMS><<<dim3(H / hpb, B, n_kt), kWgThreads,
                                   T::KV_SMEM, st>>>(
        tq, tk, tv, tdo, lf, df, flag, static_cast<float*>(dk_part),
        static_cast<float*>(dv_part), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), S, H, hkv, B, hpb, scale, scale_log2);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bwd_dq_wg<HD, TERMS><<<dim3(H, B,
                                      (S + T::DQ_ROWS - 1) / T::DQ_ROWS),
                                 kWgThreads, T::DQ_SMEM, st>>>(
        tq, tk, tv, tdo, lf, df, flag, static_cast<bf16*>(dq), S, H, hkv, B,
        scale_log2, scale);
    return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_wg(const void* q, const void* k, const void* v, const void* lse,
              const void* delta, const void* dterms, const void* lo, void* dq,
              void* dk, void* dv, void* dk_part, void* dv_part, int B, int S,
              int H, int hkv, float scale, int terms, bool* summed,
              cudaStream_t st) {
    switch (terms) {
        case 1: return launch_wg<HD, 1>(q, k, v, lse, delta, dterms, lo, dq, dk, dv, dk_part, dv_part, B, S, H, hkv, scale, summed, st);
        case 2: return launch_wg<HD, 2>(q, k, v, lse, delta, dterms, lo, dq, dk, dv, dk_part, dv_part, B, S, H, hkv, scale, summed, st);
        default: return launch_wg<HD, 3>(q, k, v, lse, delta, dterms, lo, dq, dk, dv, dk_part, dv_part, B, S, H, hkv, scale, summed, st);
    }
}

// ---------------------------------------------------------------------------
// hd 16 and 32: the mma.sync form
// ---------------------------------------------------------------------------

// element offset of (row r, column c) in a width-HD tile: rows padded by
// 16 bytes, so that ldmatrix reads are free of bank conflicts
template <int HD>
struct Wide {
    __device__ __forceinline__ int operator()(int r, int c) const {
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
    static_assert(HD == 16 || HD == 32, "the mma.sync form takes hd 16, 32");
    static constexpr int RW = HD + 8;
    // dK/dV pass: BC keys a block, BR query rows a step
    static constexpr int BC = 64;
    static constexpr int BR = 64;
    static constexpr int PLD = BR + 8;
    // a stage: q (BR rows), dout's terms (BR rows each), lse and delta
    static constexpr int KV_STAGE = 2 * (BR * RW + kTerms * BR * RW) + 8 * BR;
    static constexpr int KV_SMEM =
        2 * 2 * BC * RW + 2 * KV_STAGE + 2 * 2 * kTerms * BC * PLD;
    // dQ pass: QR query rows a block, QC keys a step
    static constexpr int QR = 64;
    static constexpr int QC = 64;
    static constexpr int SLD = QC + 8;
    static constexpr int DQ_STAGE = 2 * 2 * QC * RW;          // K, then V
    static constexpr int DQ_SMEM = 2 * (QR * RW + kTerms * QR * RW)
                                   + 8 * QR + 2 * DQ_STAGE
                                   + 2 * kTerms * QR * SLD;
    static_assert(KV_SMEM <= 232448 && DQ_SMEM <= 232448,
                  "a block's shared memory exceeds the card's 227 KiB");
};

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

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, const void* lse,
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
    // 16-byte copies (cp.async) and TMA reads of q, k, v and dout's terms
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
                           H, S, hd, rows);
    e0 = cudaGetLastError();
    if (e0 != cudaSuccess) return static_cast<int>(e0);
    if (terms > 1) {
        const long long blocks = (rows * hd + kThreads - 1) / kThreads;
        flash_bwd_low_terms<<<static_cast<unsigned>(
                                  blocks < 1056 ? blocks : 1056),
                              kThreads, 0, st>>>(
            static_cast<const float*>(dout), dout_sb, dout_sh, dout_ss,
            static_cast<bf16*>(dterms), static_cast<const int*>(lo), H, S,
            hd, rows, terms);
        e0 = cudaGetLastError();
        if (e0 != cudaSuccess) return static_cast<int>(e0);
    }
    int rc;
    bool summed = false;
    switch (hd) {
        case 16: rc = launch_mma<16>(q, k, v, lse, delta, dterms, lo, dq, dk_part, dv_part, B, S, H, hkv, scale, terms, st); break;
        case 32: rc = launch_mma<32>(q, k, v, lse, delta, dterms, lo, dq, dk_part, dv_part, B, S, H, hkv, scale, terms, st); break;
        case 64: rc = launch_wg<64>(q, k, v, lse, delta, dterms, lo, dq, dk, dv, dk_part, dv_part, B, S, H, hkv, scale, terms, &summed, st); break;
        case 128: rc = launch_wg<128>(q, k, v, lse, delta, dterms, lo, dq, dk, dv, dk_part, dv_part, B, S, H, hkv, scale, terms, &summed, st); break;
        case 256: rc = launch_wg<256>(q, k, v, lse, delta, dterms, lo, dq, dk, dv, dk_part, dv_part, B, S, H, hkv, scale, terms, &summed, st); break;
        default: return -2;
    }
    if (rc != 0 || summed) return rc;
    const long long n = static_cast<long long>(B) * S * hkv * hd;
    const long long blocks = (n + kThreads - 1) / kThreads;
    flash_bwd_finish<<<static_cast<unsigned>(blocks < 1056 ? blocks : 1056),
                       kThreads, 0, st>>>(
        static_cast<const float*>(dk_part), static_cast<const float*>(dv_part),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, hd, H / hkv,
        scale);
    return static_cast<int>(cudaGetLastError());
}
