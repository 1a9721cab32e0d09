// The in-place switch: bf16 values -> symmetric groupwise int4 (two
// nibbles per byte) + one scale per group, for sm_90a.
//
// Replaces the TPU kernel `_repack_kernel` of
// src/repro/kernels/ips_repack/kernel.py (Pallas, one arena page per
// program, output aliased over the input). Per group of `group` values
// along the feature axis:
//   scale = absmax * float32(1/7)
//   q     = rint(x / max(scale, 1e-12)), clip to +-7, +8; value 2i in the
//           low nibble of byte i, value 2i+1 in the high one
// The reference's text divides by 7; compiled (jax.jit, and the Pallas
// kernel) XLA multiplies by the rounded reciprocal instead, and this
// kernel does what the compiled reference does. The bytes and scales
// equal the compiled reference's `quantize_int4` bit for bit, for every
// even group that divides the feature axis.
//
// Two entry points share the device code:
//   ips_quantize_into  the tier form on the serving path: up to four
//                      channels (K and V) in one launch, each read where
//                      it lies in the hot tier (runs of rows at any two
//                      leading strides) and written straight into its
//                      dense tier at the watermark, scales in the tier's
//                      dtype (bf16 rounded to nearest even, or float32).
//                      Its contiguous case is `quantize_rows`.
//   ips_repack_arena   the TPU kernel's contract: an arena of pages, each
//                      `tokens * feat` bf16 values, densified in place:
//                      packed bytes, then the bf16 scales, then the stale
//                      tail left as it was.
//
// Bound on this card: bytes. Each value is read once (2 bytes) and
// leaves 0.5 + 2/group bytes (bf16 scales). Measured on an H100 (PERF.md),
// loads and stores alone run at the copy rate and the arithmetic, some 12
// instructions a value, costs as much again; what the design does:
//   * Values move in chunks of V = 8 (16 bytes; V = 4 or 2 when the group
//     or the alignment forbids 8), copied by cp.async into shared memory,
//     each thread's copies coalesced across the warp: a tile of 256
//     threads x 4 chunks a block (the tier form: one tile a block, which
//     measured faster than a persistent grid), a ring of two tiles in
//     flight (the arena form, whose CTA takes several).
//   * Shuffle form (a group of 1, 2, 4, 8, 16 or 32 chunks: group 64 is
//     8): a group is neighbouring lanes, its absmax a butterfly of
//     shuffles. A thread's 4 chunks go through each step together, so
//     that their latencies overlap.
//   * Shared form (any other group: 6, 48, 512, ...): the block takes
//     whole groups, their absmax by atomic max in shared memory on the
//     float bits of |x| (the integer order of a non-negative float's bits
//     is the value order, and NaN sorts above infinity, as the
//     reference's max propagates it).
//   * The quotient by reciprocals, not a division a value: r =
//     rcp.approx(safe) (within 2^-23), bracketed as rcp_lo = r (1 - 2^-17)
//     and rcp_hi = r (1 + 2^-17), so that x * rcp_lo and x * rcp_hi
//     enclose the reference's RN(x / safe). fma(x, rcp, 1.5 * 2^23 + 8)
//     rounds the exact product to an integer, half to even, with q + 8 in
//     its low byte (|x / safe| <= 7 (1 + 1e-7), since |x| <= absmax and
//     safe >= absmax * (1/7) rounded). Where the two brackets round alike
//     the reference's quotient rounds alike too (rint is monotonic);
//     where they differ (a quotient within some 2^-17 of a half-integer,
//     the +-7.5 clip among them: rare, exact ties included) the chunk
//     takes the IEEE division instead, out of line. Two FFMA and one LOP3
//     a value. A group holding an infinity or a NaN also takes the
//     division, where NaN gives nibble 0 as the reference's cast does.
//
// The arena form writes over what it reads. Each page is one thread-
// block cluster (8 CTAs at the default 256 x 1024 page): each CTA reads
// its share of the page's rows, forms their packed bytes and bf16 scales
// in its own shared memory, then the cluster barrier, so that every read
// of the page precedes any write of it; then each CTA writes its share.
// The stale tail is never touched.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;                       // chunks a thread, a tile
constexpr int kTile = kThreads * kItems;        // chunks a tile
constexpr int kMaxChannels = 4;
constexpr int kMaxSmem = 232448;
constexpr int kMaxCluster = 8;
constexpr int kArenaStages = 2;                 // ring stages, arena form
constexpr float kInvInt4Max = 1.0f / 7.0f;      // float32(1/7)
constexpr float kMagic = 12582920.0f;           // 1.5 * 2^23 + 8
constexpr float kUp = 1.0f + 7.62939453125e-06f;      // 1 + 2^-17
constexpr float kDown = 1.0f - 7.62939453125e-06f;    // 1 - 2^-17
constexpr float kTiny = 1e-12f;

enum Form { kShared = 0, kShuffle = 1 };

__device__ __forceinline__ float max_nan(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

__device__ __forceinline__ float rcp_approx(float x) {
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(uint8_t* dst, const void* src,
                                         bool valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = valid ? BYTES : 0;       // 0: fill the slot with zeros
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                     :: "r"(d), "l"(src), "r"(n) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;"
                     :: "r"(d), "l"(src), "n"(BYTES), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// N 32-bit words from p (aligned to min(16, 4N) bytes); NC reads through
// the read-only path (never for the arena, which this kernel writes)
template <int N, bool NC>
__device__ __forceinline__ void load_words(const uint32_t* p,
                                           uint32_t (&w)[N]) {
    if constexpr (N % 4 == 0) {
#pragma unroll
        for (int k = 0; k < N; k += 4) {
            const uint4* q = reinterpret_cast<const uint4*>(p + k);
            uint4 v;
            if constexpr (NC) v = __ldg(q); else v = *q;
            w[k] = v.x; w[k + 1] = v.y; w[k + 2] = v.z; w[k + 3] = v.w;
        }
    } else if constexpr (N == 2) {
        const uint2* q = reinterpret_cast<const uint2*>(p);
        uint2 v;
        if constexpr (NC) v = __ldg(q); else v = *q;
        w[0] = v.x; w[1] = v.y;
    } else {
        if constexpr (NC) w[0] = __ldg(p); else w[0] = *p;
    }
}

template <int V, bool F32>
__device__ __forceinline__ void unpack(const uint32_t* w, float (&x)[V]) {
    if constexpr (F32) {
#pragma unroll
        for (int k = 0; k < V; ++k) x[k] = __uint_as_float(w[k]);
    } else {
#pragma unroll
        for (int k = 0; k < V / 2; ++k) {
            x[2 * k] = __uint_as_float(w[k] << 16);
            x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
        }
    }
}

// max |x| of a chunk, as a tree (a chain three deep at V = 8)
template <int V>
__device__ __forceinline__ float chunk_absmax(const float (&x)[V]) {
    float a[V];
#pragma unroll
    for (int k = 0; k < V; ++k) a[k] = fabsf(x[k]);
#pragma unroll
    for (int step = 1; step < V; step *= 2)
#pragma unroll
        for (int k = 0; k + step < V; k += 2 * step)
            a[k] = max_nan(a[k], a[k + step]);
    return a[0];
}

// A group's scale, and 1/safe bracketed: rcp_lo < 1/safe < rcp_hi by a
// relative 2^-17 either way (rcp.approx is within 2^-23)
struct Scale {
    float scale, safe, rcp_hi, rcp_lo;
    bool finite;
};

__device__ __forceinline__ Scale group_scale(float amax) {
    Scale s;
    s.scale = __fmul_rn(amax, kInvInt4Max);
    s.safe = s.scale < kTiny ? kTiny : s.scale;   // NaN stays, as jnp.maximum
    const float r = rcp_approx(s.safe);
    s.rcp_hi = __fmul_rn(r, kUp);
    s.rcp_lo = __fmul_rn(r, kDown);
    s.finite = amax < __int_as_float(0x7f800000);
    return s;
}

__device__ __forceinline__ uint32_t exact_nibble(float x, float safe) {
    const float q = rintf(__fdiv_rn(x, safe));
    if (q != q) return 0u;                  // NaN casts to 0
    return static_cast<uint32_t>(
        static_cast<int>(fminf(fmaxf(q, -7.0f), 7.0f)) + 8);
}

// Nibbles t (each in the low byte of its word, the four bits above it
// clear) packed two a byte: t_odd * 16 + t_even has the byte in its low
// byte; V/2 bytes in the low bits of the result.
template <int V>
__device__ __forceinline__ uint32_t pack(const uint32_t (&t)[V]) {
    uint32_t p[V / 2];
#pragma unroll
    for (int k = 0; k < V / 2; ++k) p[k] = t[2 * k + 1] * 16u + t[2 * k];
    if constexpr (V == 2) {
        return p[0] & 0xffu;
    } else if constexpr (V == 4) {
        return __byte_perm(p[0], p[1], 0x0040) & 0xffffu;
    } else {
        return __byte_perm(__byte_perm(p[0], p[1], 0x0040),
                           __byte_perm(p[2], p[3], 0x0040), 0x5410);
    }
}

// The chunk's V nibbles packed into V/2 bytes (low bits of the result),
// by the bracketing reciprocals; `differ` collects the bits in which the
// two brackets' roundings differ (0 where every value rounds alike).
template <int V>
__device__ __forceinline__ uint32_t quantize_fast(const float (&x)[V],
                                                  const Scale& s,
                                                  uint32_t& differ) {
    uint32_t t[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
        const uint32_t hi = __float_as_uint(__fmaf_rn(x[k], s.rcp_hi, kMagic));
        const uint32_t lo = __float_as_uint(__fmaf_rn(x[k], s.rcp_lo, kMagic));
        differ |= hi ^ lo;
        t[k] = hi;                          // low byte: q + 8, in 1..15
    }
    return pack<V>(t);
}

// The same by the IEEE division, where q + 8 is built exactly.
template <int V>
__device__ __forceinline__ uint32_t quantize_exact(const float (&x)[V],
                                                   float safe) {
    uint32_t t[V];
#pragma unroll
    for (int k = 0; k < V; ++k) t[k] = exact_nibble(x[k], safe);
    return pack<V>(t);
}

// A chunk of words read again from shared memory, quantized by the
// division: the rare path, out of line so that the hot loop stays small.
template <int V, bool F32>
__device__ __noinline__ uint32_t requantize(const uint32_t* words,
                                            float safe) {
    uint32_t w[F32 ? V : V / 2];
#pragma unroll
    for (int k = 0; k < (F32 ? V : V / 2); ++k) w[k] = words[k];
    float x[V];
    unpack<V, F32>(w, x);
    return quantize_exact<V>(x, safe);
}

template <int V>
__device__ __forceinline__ uint32_t quantize_chunk(const float (&x)[V],
                                                   const Scale& s) {
    uint32_t differ = 0;
    const uint32_t q = quantize_fast<V>(x, s, differ);
    return (differ != 0 || !s.finite) ? quantize_exact<V>(x, s.safe) : q;
}

template <int V>
__device__ __forceinline__ void store_packed(uint8_t* dst, uint32_t q) {
    if constexpr (V == 8) *reinterpret_cast<uint32_t*>(dst) = q;
    else if constexpr (V == 4) *reinterpret_cast<uint16_t*>(dst) =
        static_cast<uint16_t>(q);
    else *dst = static_cast<uint8_t>(q);
}

template <bool BF16>
__device__ __forceinline__ void store_scale(void* scales, long long g,
                                            float s) {
    if constexpr (BF16)
        static_cast<__nv_bfloat16*>(scales)[g] = __float2bfloat16_rn(s);
    else
        static_cast<float*>(scales)[g] = s;
}

// One tile of a span of n_chunks chunks read from `in`: packed byte of
// chunk j at packed + j*V/2, scale of group g at scales[g].
struct Span {
    const uint32_t* in;
    uint8_t* packed;
    void* scales;
    long long n_chunks, tile;
};

template <int V, bool F32>
__host__ __device__ constexpr int chunk_bytes() {
    return F32 ? 4 * V : 2 * V;
}
template <int V, bool F32>
__host__ __device__ constexpr int stage_bytes() {
    return kTile * chunk_bytes<V, F32>();
}

// Copies of a tile's chunks, j = tile * kTile + i * kThreads + threadIdx.x
// (i < kItems), into this thread's slots of a ring stage; chunks past the
// span's end are zeros.
template <int V, bool F32>
__device__ __forceinline__ void issue_tile(const Span& sp, uint8_t* stage) {
    constexpr int CB = chunk_bytes<V, F32>();
    constexpr int PIECE = CB < 16 ? CB : 16;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
        const int c = i * kThreads + threadIdx.x;
        const long long j = sp.tile * kTile + c;
        const bool ok = j < sp.n_chunks;
        const uint8_t* src = reinterpret_cast<const uint8_t*>(sp.in)
                             + (ok ? j * CB : 0);
#pragma unroll
        for (int k = 0; k < CB; k += PIECE)
            cp_async<PIECE>(stage + c * CB + k, src + k, ok);
    }
}

// Shuffle form: a tile in a ring stage, a group being `lanes` neighbouring
// lanes (a power of two <= 32; the span starts on a group). The thread's
// kItems chunks go through each step together (absmax, shuffles, scale,
// quotients), so that their latencies overlap.
template <int V, bool F32, bool SC_BF16>
__device__ __forceinline__ void quantize_shuffle(const Span& sp,
                                                 const uint8_t* stage,
                                                 int lanes, int lane_shift) {
    constexpr int W = F32 ? V : V / 2;
    constexpr int CB = chunk_bytes<V, F32>();
    float x[kItems][V];
    float a[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
        const uint32_t* words = reinterpret_cast<const uint32_t*>(
            stage + (i * kThreads + threadIdx.x) * CB);
        uint32_t w[W];
#pragma unroll
        for (int k = 0; k < W; ++k) w[k] = words[k];
        unpack<V, F32>(w, x[i]);
        a[i] = chunk_absmax<V>(x[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        if (off < lanes) {
#pragma unroll
            for (int i = 0; i < kItems; ++i)
                a[i] = max_nan(a[i], __shfl_xor_sync(0xffffffffu, a[i], off));
        }
    }
    Scale sc[kItems];
    uint32_t q[kItems];
    unsigned redo = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
        sc[i] = group_scale(a[i]);
        uint32_t differ = 0;
        q[i] = quantize_fast<V>(x[i], sc[i], differ);
        redo |= static_cast<unsigned>(differ != 0 || !sc[i].finite) << i;
    }
    if (redo) {
        for (int i = 0; i < kItems; ++i) {
            if (redo >> i & 1u)
                q[i] = requantize<V, F32>(reinterpret_cast<const uint32_t*>(
                    stage + (i * kThreads + threadIdx.x) * CB), sc[i].safe);
        }
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
        const long long j = sp.tile * kTile + i * kThreads + threadIdx.x;
        if (j < sp.n_chunks) {
            store_packed<V>(sp.packed + j * (V / 2), q[i]);
            if ((threadIdx.x & (lanes - 1)) == 0)
                store_scale<SC_BF16>(sp.scales, j >> lane_shift, sc[i].scale);
        }
    }
}

// Work items first, first + stride, ... below total, item(w) a Span of
// one tile, through a ring of S stages: the copies of the next S - 1
// items in flight while this one is quantized. A thread reads back only
// its own slots, so the ring needs no barrier.
template <int V, bool F32, bool SC_BF16, int S, class Item>
__device__ __forceinline__ void stream_tiles(const Item& item, long long first,
                                             long long stride,
                                             long long total, int lanes,
                                             int lane_shift, uint8_t* ring) {
    constexpr int STAGE = stage_bytes<V, F32>();
#pragma unroll
    for (int k = 0; k < S - 1; ++k) {
        const long long w = first + k * stride;
        if (w < total) issue_tile<V, F32>(item(w), ring + k * STAGE);
        cp_commit();
    }
    for (long long k = 0; first + k * stride < total; ++k) {
        const long long ahead = first + (k + S - 1) * stride;
        if (ahead < total)
            issue_tile<V, F32>(item(ahead), ring + ((k + S - 1) % S) * STAGE);
        cp_commit();
        cp_wait<S - 1>();
        quantize_shuffle<V, F32, SC_BF16>(item(first + k * stride),
                                          ring + (k % S) * STAGE, lanes,
                                          lane_shift);
    }
    cp_wait<0>();
}

// Shared form, for any `lanes`: the block takes whole groups (kTile /
// lanes of them, or one group of more than kTile chunks), their absmax by
// atomic max in shared memory, then reads its chunks a second time.
template <int V, bool F32, bool SC_BF16, bool NC>
__device__ __forceinline__ void tile_shared(const uint32_t* in,
                                            uint8_t* packed, void* scales,
                                            long long n_chunks, int lanes,
                                            long long tile,
                                            unsigned* amax) {
    constexpr int W = F32 ? V : V / 2;
    const int per = lanes >= kTile ? 1 : kTile / lanes;
    const long long g0 = tile * per;
    const long long left = n_chunks / lanes - g0;
    const int ng = static_cast<int>(left < per ? left : per);
    const long long c0 = g0 * lanes;
    const int span = ng * lanes;
    __syncthreads();                // a previous tile may still read amax
    for (int g = threadIdx.x; g < ng; g += kThreads) amax[g] = 0u;
    __syncthreads();
    for (int k = threadIdx.x; k < span; k += kThreads) {
        uint32_t w[W];
        float x[V];
        load_words<W, NC>(in + (c0 + k) * W, w);
        unpack<V, F32>(w, x);
        atomicMax(&amax[k / lanes], __float_as_uint(chunk_absmax<V>(x)));
    }
    __syncthreads();
    for (int g = threadIdx.x; g < ng; g += kThreads)
        store_scale<SC_BF16>(scales, g0 + g,
                             group_scale(__uint_as_float(amax[g])).scale);
    for (int k = threadIdx.x; k < span; k += kThreads) {
        uint32_t w[W];
        float x[V];
        load_words<W, NC>(in + (c0 + k) * W, w);
        unpack<V, F32>(w, x);
        const Scale s = group_scale(__uint_as_float(amax[k / lanes]));
        store_packed<V>(packed + (c0 + k) * (V / 2), quantize_chunk<V>(x, s));
    }
}

struct Channel {
    const void* src;        // run (a, b) at src + a*src_sa + b*src_sb
    uint8_t* packed;        // at the watermark
    void* scales;           // at the watermark
    long long src_sa, src_sb, pk_sa, pk_sb, sc_sa, sc_sb;   // elements
};

struct TierArgs {
    Channel ch[kMaxChannels];
    long long run_chunks;   // chunks of V values in one run
    int n_b, lanes, lane_shift;
};

// grid: (tiles of a run, runs a * n_b + b, channels), a tile a block
template <int V, bool F32, bool SC_BF16, int FORM>
__global__ void __launch_bounds__(kThreads)
tier_kernel(const __grid_constant__ TierArgs args) {
    extern __shared__ __align__(16) uint8_t ring[];
    __shared__ unsigned amax[FORM == kShared ? kTile : 1];
    const Channel& c = args.ch[blockIdx.z];
    const long long a = blockIdx.y / args.n_b;
    const long long b = blockIdx.y - a * args.n_b;
    const uint32_t* in = reinterpret_cast<const uint32_t*>(
        static_cast<const char*>(c.src)
        + (a * c.src_sa + b * c.src_sb) * (F32 ? 4 : 2));
    uint8_t* packed = c.packed + a * c.pk_sa + b * c.pk_sb;
    void* scales = static_cast<char*>(c.scales)
                   + (a * c.sc_sa + b * c.sc_sb) * (SC_BF16 ? 2 : 4);
    if constexpr (FORM == kShared) {
        tile_shared<V, F32, SC_BF16, true>(in, packed, scales,
                                           args.run_chunks, args.lanes,
                                           blockIdx.x, amax);
    } else {
        auto item = [&](long long t) {
            return Span{in, packed, scales, args.run_chunks, t};
        };
        stream_tiles<V, F32, SC_BF16, 1>(item, blockIdx.x, gridDim.x,
                                         gridDim.x, args.lanes,
                                         args.lane_shift, ring);
    }
}

__device__ __forceinline__ void copy_out(uint8_t* dst, const uint8_t* src,
                                         long long n) {
    const uintptr_t al = reinterpret_cast<uintptr_t>(dst)
                         | static_cast<uintptr_t>(n);
    if ((al & 15) == 0) {
        for (long long i = threadIdx.x; i < n / 16; i += kThreads)
            reinterpret_cast<uint4*>(dst)[i] =
                reinterpret_cast<const uint4*>(src)[i];
    } else if ((al & 3) == 0) {
        for (long long i = threadIdx.x; i < n / 4; i += kThreads)
            reinterpret_cast<uint32_t*>(dst)[i] =
                reinterpret_cast<const uint32_t*>(src)[i];
    } else {
        for (long long i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
    }
}

template <int V, int FORM>
__host__ __device__ constexpr int arena_ring_bytes() {
    return FORM == kShared ? 0 : kArenaStages * stage_bytes<V, false>();
}

// One cluster of `csize` CTAs a page: CTA `rank` takes rows
// [tokens*rank/csize, tokens*(rank+1)/csize). Dynamic shared memory: the
// ring, then the share's packed bytes, then (packed_smem further, a
// multiple of 16) its bf16 scales.
template <int V, int FORM>
__global__ void __launch_bounds__(kThreads)
arena_kernel(uint8_t* arena, long long page_bytes, int tokens, int feat,
             int group, int lanes, int lane_shift, int csize,
             int packed_smem) {
    extern __shared__ __align__(16) uint8_t smem[];
    __shared__ unsigned amax[FORM == kShared ? kTile : 1];
    const int rank = blockIdx.x % csize;
    uint8_t* page = arena + static_cast<long long>(blockIdx.x / csize)
                            * page_bytes;
    const int r0 = static_cast<int>(static_cast<long long>(tokens) * rank
                                    / csize);
    const int r1 = static_cast<int>(static_cast<long long>(tokens)
                                    * (rank + 1) / csize);
    const long long n_vals = static_cast<long long>(r1 - r0) * feat;
    const long long n_chunks = n_vals / V;
    const uint32_t* in = reinterpret_cast<const uint32_t*>(
        page + 2LL * r0 * feat);
    uint8_t* pk = smem + arena_ring_bytes<V, FORM>();
    uint8_t* sc = pk + packed_smem;
    if constexpr (FORM == kShared) {
        const long long n_groups = n_chunks / lanes;
        const int per = lanes >= kTile ? 1 : kTile / lanes;
        for (long long t = 0; t * per < n_groups; ++t)
            tile_shared<V, false, true, false>(in, pk, sc, n_chunks, lanes,
                                               t, amax);
    } else {
        auto item = [&](long long t) {
            return Span{in, pk, sc, n_chunks, t};
        };
        stream_tiles<V, false, true, kArenaStages>(
            item, 0, 1, (n_chunks + kTile - 1) / kTile, lanes, lane_shift,
            smem);
    }
    __syncthreads();
    // every CTA of the page has read its rows: only now may any write
    asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
                 "barrier.cluster.wait.acquire.aligned;" ::: "memory");
    const long long groups = feat / group;
    copy_out(page + static_cast<long long>(r0) * feat / 2, pk, n_vals / 2);
    copy_out(page + static_cast<long long>(tokens) * feat / 2
             + 2LL * r0 * groups, sc, 2LL * (r1 - r0) * groups);
}

template <int V, bool F32, bool SC_BF16, int FORM>
int launch_tier(const TierArgs& args, dim3 grid, cudaStream_t st) {
    auto kernel = tier_kernel<V, F32, SC_BF16, FORM>;
    const int smem = FORM == kShared ? 0 : stage_bytes<V, F32>();
    if (smem > 48 * 1024) {
        static bool set = false;
        if (!set) {
            const cudaError_t e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (e != cudaSuccess) return static_cast<int>(e);
            set = true;
        }
    }
    kernel<<<grid, kThreads, smem, st>>>(args);
    return static_cast<int>(cudaGetLastError());
}

template <int V, int FORM>
int dispatch_tier(const TierArgs& args, dim3 grid, bool f32, bool sc_bf16,
                  cudaStream_t st) {
    if (f32)
        return sc_bf16 ? launch_tier<V, true, true, FORM>(args, grid, st)
                       : launch_tier<V, true, false, FORM>(args, grid, st);
    return sc_bf16 ? launch_tier<V, false, true, FORM>(args, grid, st)
                   : launch_tier<V, false, false, FORM>(args, grid, st);
}

template <int V, int FORM>
int launch_arena(uint8_t* arena, long long pages, long long page_bytes,
                 int tokens, int feat, int group, int lanes, int lane_shift,
                 int csize, int packed_smem, int smem, cudaStream_t st) {
    auto kernel = arena_kernel<V, FORM>;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(pages * csize));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(csize);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, kernel, arena, page_bytes, tokens, feat, group, lanes,
        lane_shift, csize, packed_smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

int check_group(int feat, int group) {
    if (group < 2 || group % 2 != 0) return -2;
    if (feat <= 0 || feat % group != 0) return -3;
    return 0;
}

int log2i(int n) {
    int s = 0;
    while ((1 << s) < n) ++s;
    return s;
}

int form_of(int lanes) {
    return lanes <= 32 && (lanes & (lanes - 1)) == 0 ? kShuffle : kShared;
}

// The arena form's chunk size, form, cluster size and shared memory: V
// the largest of 8, 4, 2 that the group and the alignment allow
struct ArenaPlan {
    int v, form, csize, packed_smem;
    long long smem;
};

ArenaPlan arena_plan(int tokens, int feat, int group, uintptr_t align) {
    ArenaPlan p;
    p.v = 8;
    while (p.v > 2 && (group % p.v != 0 || align % (2 * p.v) != 0)) p.v /= 2;
    p.form = form_of(group / p.v);
    p.csize = kMaxCluster;          // a power of two, at most one CTA a row
    while (p.csize > tokens) p.csize /= 2;
    const long long rows = (tokens + p.csize - 1) / p.csize;
    p.packed_smem = static_cast<int>((rows * feat / 2 + 15) / 16 * 16);
    const int ring = p.v == 8 ? arena_ring_bytes<8, kShuffle>()
                     : p.v == 4 ? arena_ring_bytes<4, kShuffle>()
                                : arena_ring_bytes<2, kShuffle>();
    p.smem = (p.form == kShared ? 4LL * kTile : ring) + p.packed_smem
             + 2 * rows * (feat / group);
    return p;
}

}  // namespace

// desc: n_ch rows of 9 int64: src, packed (at the watermark), scales (at
// the watermark) pointers, then the two leading strides of each, in
// elements of its own dtype. Every channel has n_a x n_b runs of
// run_rows rows of feat values, contiguous within a run.
extern "C" int ips_quantize_into(int n_ch, const long long* desc, int n_a,
                                 int n_b, long long run_rows, int feat,
                                 int group, int x_is_bf16, int sc_is_bf16,
                                 void* stream) {
    if (n_ch < 1 || n_ch > kMaxChannels) return -1;
    const int bad = check_group(feat, group);
    if (bad) return bad;
    if (n_a < 0 || n_b < 0 || run_rows < 0) return -4;
    const long long runs = static_cast<long long>(n_a) * n_b;
    if (runs == 0 || run_rows == 0) return 0;
    if (runs > 65535) return -6;
    const long long esz = x_is_bf16 ? 2 : 4;
    int v = 8;
    for (; v >= 2; v /= 2) {
        if (group % v != 0) continue;
        bool ok = true;
        for (int c = 0; c < n_ch; ++c) {
            const long long* d = desc + 9 * c;
            ok = ok && d[0] % (v * esz) == 0 && d[3] % v == 0
                 && d[4] % v == 0 && d[1] % (v / 2) == 0
                 && d[5] % (v / 2) == 0 && d[6] % (v / 2) == 0;
        }
        if (ok) break;
    }
    if (v < 2) return -5;
    TierArgs args = {};
    for (int c = 0; c < n_ch; ++c) {
        const long long* d = desc + 9 * c;
        Channel& ch = args.ch[c];
        ch.src = reinterpret_cast<const void*>(d[0]);
        ch.packed = reinterpret_cast<uint8_t*>(d[1]);
        ch.scales = reinterpret_cast<void*>(d[2]);
        ch.src_sa = d[3]; ch.src_sb = d[4];
        ch.pk_sa = d[5]; ch.pk_sb = d[6];
        ch.sc_sa = d[7]; ch.sc_sb = d[8];
    }
    const bool f32 = !x_is_bf16, bf16 = sc_is_bf16 != 0;
    const int lanes = group / v;
    const int form = form_of(lanes);
    args.run_chunks = run_rows * feat / v;
    args.n_b = n_b;
    args.lanes = lanes;
    args.lane_shift = log2i(lanes);
    long long tiles;
    if (form == kShared) {
        const long long per = lanes >= kTile ? 1 : kTile / lanes;
        tiles = (args.run_chunks / lanes + per - 1) / per;
    } else {
        tiles = (args.run_chunks + kTile - 1) / kTile;
    }
    if (tiles > INT_MAX) return -6;
    const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(runs),
                    static_cast<unsigned>(n_ch));
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define IPS_TIER(V_, FORM_) dispatch_tier<V_, FORM_>(args, grid, f32, bf16, st)
    if (form == kShuffle) {
        if (v == 8) return IPS_TIER(8, kShuffle);
        if (v == 4) return IPS_TIER(4, kShuffle);
        return IPS_TIER(2, kShuffle);
    }
    if (v == 8) return IPS_TIER(8, kShared);
    if (v == 4) return IPS_TIER(4, kShared);
    return IPS_TIER(2, kShared);
#undef IPS_TIER
}

// Shared memory a CTA of the arena form needs, or -1 where the page's
// alignment is refused.
extern "C" long long ips_arena_smem(int tokens, int feat, int group,
                                    long long align) {
    if (check_group(feat, group) || tokens <= 0 || (align & 3) != 0)
        return -1;
    return arena_plan(tokens, feat, group, static_cast<uintptr_t>(align)).smem;
}

extern "C" int ips_repack_arena(void* arena, long long pages,
                                long long page_bytes, int tokens, int feat,
                                int group, void* stream) {
    const int bad = check_group(feat, group);
    if (bad) return bad;
    const uintptr_t align = reinterpret_cast<uintptr_t>(arena)
                            | static_cast<uintptr_t>(page_bytes);
    if (tokens <= 0 || page_bytes < 2LL * tokens * feat || (align & 3) != 0)
        return -5;
    if (pages <= 0) return 0;
    const ArenaPlan p = arena_plan(tokens, feat, group, align);
    if (pages * p.csize > INT_MAX) return -6;
    if (p.smem > kMaxSmem) return -7;
    const int lanes = group / p.v;
    const int shift = log2i(lanes);
    uint8_t* a = static_cast<uint8_t*>(arena);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int ps = p.packed_smem, sm = static_cast<int>(p.smem);
#define IPS_ARENA(V_, FORM_)                                                  \
    launch_arena<V_, FORM_>(a, pages, page_bytes, tokens, feat, group,       \
                            lanes, shift, p.csize, ps, sm, st)
    if (p.form == kShuffle) {
        if (p.v == 8) return IPS_ARENA(8, kShuffle);
        if (p.v == 4) return IPS_ARENA(4, kShuffle);
        return IPS_ARENA(2, kShuffle);
    }
    if (p.v == 8) return IPS_ARENA(8, kShared);
    if (p.v == 4) return IPS_ARENA(4, kShared);
    return IPS_ARENA(2, kShared);
#undef IPS_ARENA
}
