// The latent form of the tiered decode attention, for sm_90a: MLA's
// absorbed decode against the int4 latent tier, with the dequantization
// fused and both products on the tensor cores.
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
// Bound on this card: bytes. Each token brings r/2 bytes of the latent,
// its bf16 scales and p bf16 of RoPE key (400 bytes at r 512, p 64,
// group 64: 0.12 ns at 3.35 TB/s); its 2 * H * (2r + p) operations run on
// the bf16 tensor cores (0.04 ns at 989 TFLOP/s, twice that with q's and
// p's second terms). At deepseek-v2-lite's decode (B 4, H 16, dense_len
// 2048) that is 1.06 us of bytes.
//
// Both products are mma.sync m16n8k16, bf16 in, float32 accumulate; the
// 16 heads are one m16 A tile (H < 16 pads with zero rows).
// - scores S (16 x n) = Q (16 x (r + p)) . [C | K_rope]^T
// - acc (16 x r) += P (16 x n) . C (n x r), C read transposed
//   (ldmatrix.trans) from the same dequantized tile.
// Precision: each operand is exact in bf16 or split into bf16 terms
// whose products, summed in float32, meet the 2e-5 of max |output| bar
// (tests/test_torch_mla.py emulates the arithmetic at deepseek's shape).
// - C is bf16 by construction (the tier's dequantization rounds to bf16,
//   as the plain version does): exact.
// - q is float32 in the contract; each warp splits it once into q_hi =
//   bf16(q), q_lo = bf16(q - q_hi) and q_lo2 = bf16(q - q_hi - q_lo) and
//   adds the q_lo and q_lo2 products only where some q_lo of its slice is
//   not 0. On the serving path q_lat and q_rope are bf16 values (MLA forms
//   them in bf16): q_lo is 0 and the scores are exact products summed in
//   float32. For a float32 q two terms (2^-17 of q) leave some 1.2e-5 of
//   max |output| in the emulation, too near the bar; three, 4.5e-6.
// - P is float32 in [0, 1]: p_hi = bf16(p) and p_lo = bf16(p - p_hi)
//   carry p to some 2^-17 of itself; one term (2^-9) misses the bar.
// - l sums the float32 p; m is the float32 max of the scores.
//
// Design: a block of 256 threads (8 warps) per (split of S, batch row),
// one a SM; at deepseek's decode one 64-token tile a block (128 blocks),
// the plan the card ran fastest (a cluster of blocks a batch row merging
// through distributed shared memory, each block streaming several tiles,
// ran slower: a tile's phases do not overlap across the block's warps).
// - loads: q (float32) and the first two tiles (packed latent rows, bf16
//   scales, RoPE rows) by cp.async into shared memory, q into the latent
//   tile's space until it is read out; then each next tile into a
//   two-stage ring while this one computes; rows past dense_len are
//   zeros.
// - dequantization: warp w owns latent features [64w, 64w + 64) (r / 64
//   warps) and dequantizes its slice of each token once, straight to
//   bf16 by bf16x2 arithmetic (the nibble placed in the mantissa of 128,
//   less 136, times the scale: exact, then rounded as the plain version
//   rounds), into the row-major tile ldmatrix reads. Within each 8
//   features the tile holds the order 0 4 1 5 2 6 3 7 (the order the
//   nibble pairs come out of a packed word); q is loaded in the same
//   order and acc is written back in the natural one. No integer
//   division (multiply-high quotients) and no unrolled copies of the
//   unit loop: a block runs its code once, so the code's size is time.
// - scores: warp w multiplies its 64 features (q's terms in registers,
//   split once) against the tile's 64 tokens, warps 0 .. p/16 - 1 one
//   16-wide k-step of RoPE each; the q_lo products are a branch taken
//   only for a q that is not bf16-exact (predicated, they would still
//   issue); the warps' partial scores are summed in shared memory in
//   warp order (fixed, so results are deterministic).
// - softmax: 16 threads a head, 4 tokens a thread; the tile's max, the
//   rescale factor, p = exp(s - m) and its two bf16 terms into shared
//   memory.
// - acc: warp w rescales its 16 x 64 float32 fragment and adds P . C over
//   the tile's tokens for its 64 features; the block's partial leaves
//   through shared memory in 16-byte stores, row after row.
// With several splits a merge kernel, one block per (128 features, head,
// batch row), rescales the splits' partials to their common max as
// `ref.merge_partials` does and sums them in a fixed order. One call of
// `latent_tier_partial` is one launch of the wrapper: the split kernel,
// then the merge kernel where there are several splits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeads = 16;                // one m16 tile
constexpr int kTile = 64;                 // tokens a tile
constexpr int kMaxR = 512;                // 8 warps x 64 features
constexpr float kNegInf = -1e30f;

// shared-memory strides, padded so that ldmatrix's and the 16-byte
// accesses' eight rows fall on distinct banks
__host__ __device__ constexpr int pk_stride(int r) { return r / 2 + 32; }
__host__ __device__ constexpr int rp_stride(int p) { return 2 * (p + 8); }
__host__ __device__ constexpr int c_stride(int r) { return r + 8; }
constexpr int kRedStride = kTile + 8;     // floats
constexpr int kPStride = kTile + 8;       // bf16

__host__ __device__ constexpr int sc_bytes(int r, int group) {
    return (kTile * (r / group) * 2 + 8 + 15) / 16 * 16;
}

__host__ __device__ constexpr int stage_bytes(int r, int p, int group) {
    return kTile * pk_stride(r) + kTile * rp_stride(p) + sc_bytes(r, group);
}

size_t split_smem(int r, int p, int group) {
    return 2 * static_cast<size_t>(stage_bytes(r, p, group))
           + 2 * kTile * c_stride(r)                  // the bf16 latent tile
           + 4 * kWarps * kHeads * kRedStride         // partial scores
           + 2 * 2 * kHeads * kPStride                // p_hi, p_lo
           + 4 * kHeads;                              // rescale factors
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory; `valid` false writes zeros
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// returns once every group but the newest has landed
__device__ __forceinline__ void cp_wait_prev() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* d, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
                 "[%4];\n"
                 : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
                 : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* d, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                 "{%0,%1,%2,%3}, [%4];\n"
                 : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
                 : "r"(smem_u32(p)));
}

// c += a . b, m16n8k16, bf16 in, float32 accumulate
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b,
                                               uint32_t c) {
    uint32_t d;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b),
        "r"(c));
    return d;
}

__device__ __forceinline__ uint16_t bf16_bits(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// (lo, hi) as one bf16x2 word
__device__ __forceinline__ uint32_t pack(uint16_t lo, uint16_t hi) {
    return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ float bf16_value(uint16_t b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
}

// a float32 pair split into bf16 terms: *hi = bf16(x), *lo = bf16(x - hi)
__device__ __forceinline__ void split2(float x, float y, uint32_t* hi,
                                       uint32_t* lo) {
    const uint16_t xh = bf16_bits(x), yh = bf16_bits(y);
    *hi = pack(xh, yh);
    *lo = pack(bf16_bits(x - bf16_value(xh)), bf16_bits(y - bf16_value(yh)));
}

// ... and in three: hi, lo = bf16(x - hi), lo2 = bf16(x - hi - lo), which
// carry a float32 to some 2^-25 of itself (each difference is exact)
__device__ __forceinline__ void split3(float x, float y, uint32_t* hi,
                                       uint32_t* lo, uint32_t* lo2) {
    const uint16_t xh = bf16_bits(x), yh = bf16_bits(y);
    const float xr = x - bf16_value(xh), yr = y - bf16_value(yh);
    const uint16_t xl = bf16_bits(xr), yl = bf16_bits(yr);
    *hi = pack(xh, yh);
    *lo = pack(xl, yl);
    *lo2 = pack(bf16_bits(xr - bf16_value(xl)), bf16_bits(yr - bf16_value(yl)));
}

// i / d for 0 <= i < 2^16 and 2 <= d < 2^16 by a multiply-high with
// m = ceil(2^32 / d): exact there, and no integer division in the loops
__device__ __forceinline__ int quot(int i, uint32_t m) {
    return static_cast<int>(__umulhi(static_cast<uint32_t>(i), m));
}

__device__ __forceinline__ uint32_t quot_magic(int d) {
    return 0xFFFFFFFFu / static_cast<uint32_t>(d) + 1u;
}

constexpr uint32_t kOne2 = 0x3F803F80u;      // (1, 1)
constexpr uint32_t kM136 = 0xC308C308u;      // (-136, -136)
constexpr uint32_t kNegZero2 = 0x80008000u;  // (-0, -0)

// one packed word (features f .. f + 7, nibble k = feature f + k) into
// four bf16x2 words in the tile's order (f, f+4), (f+1, f+5), ...; s01 ..
// s67 the scales of each pair
__device__ __forceinline__ uint4 deq_word(uint32_t x, uint32_t s0,
                                          uint32_t s1, uint32_t s2,
                                          uint32_t s3) {
    uint32_t v[4];
    const uint32_t sc[4] = {s0, s1, s2, s3};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        // 128 + nibble in each half, less 136: nibble - 8, exact
        const uint32_t n = ((x >> (4 * k)) & 0x000F000Fu) | 0x43004300u;
        v[k] = bf16x2_fma(bf16x2_fma(n, kOne2, kM136), sc[k], kNegZero2);
    }
    return make_uint4(v[0], v[1], v[2], v[3]);
}

__global__ void __launch_bounds__(kThreads, 1)
latent_split_kernel(const float* __restrict__ q_lat,
                    const float* __restrict__ q_rope,
                    const uint8_t* __restrict__ c4,
                    const __nv_bfloat16* __restrict__ c4_sc,
                    const __nv_bfloat16* __restrict__ krope,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    float* __restrict__ acc_out, int S, int S_raw, int H,
                    int r, int p, int group, int dense_len,
                    int split_tokens, float scale) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int PKS = pk_stride(r), RPS = rp_stride(p), CS = c_stride(r);
    const int STAGE = stage_bytes(r, p, group);
    uint8_t* ring = smem;
    __nv_bfloat16* ct = reinterpret_cast<__nv_bfloat16*>(smem + 2 * STAGE);
    float* red = reinterpret_cast<float*>(ct + kTile * CS);
    __nv_bfloat16* p_hi = reinterpret_cast<__nv_bfloat16*>(
        red + kWarps * kHeads * kRedStride);
    __nv_bfloat16* p_lo = p_hi + kHeads * kPStride;
    float* corr_s = reinterpret_cast<float*>(p_lo + kHeads * kPStride);

    const int split = blockIdx.x, b = blockIdx.y, nsplit = gridDim.x;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int t_begin = split * split_tokens;
    const int t_end = min(t_begin + split_tokens, dense_len);
    const int n_sc = r / group, half = r / 2;
    const int nfw = r / 64;                  // warps with latent features
    const int nrw = p / 16;                  // warps with a RoPE k-step
    const int nsw = max(nfw, nrw);           // warps with partial scores
    const bool lat = warp < nfw, rope = warp < nrw;
    const int fw = 64 * warp;                // this warp's first feature
    const long long row0 = static_cast<long long>(b) * S;
    const uint32_t cpr_m = quot_magic(r / 32), rpr_m = quot_magic(p / 8);
    // a feature's scale is f / group (one a packed word where group % 8
    // is 0)
    const uint32_t grp_m = quot_magic(group);
    const bool word_scale = group % 8 == 0;

    // the tile at t0 into stage st: issued, not waited for
    auto issue = [&](int t0, int st) {
        uint8_t* base = ring + st * STAGE;
        const int valid = min(kTile, t_end - t0);
        const int cpr = half / 16;
        for (int i = tid; i < kTile * cpr; i += kThreads) {
            const int row = quot(i, cpr_m), c = i - row * cpr;
            const bool ok = row < valid;
            cp16(base + row * PKS + 16 * c,
                 c4 + (row0 + t0 + (ok ? row : 0)) * half + 16 * c, ok);
        }
        uint8_t* rp = base + kTile * PKS;
        const int rpr = p / 8;
        for (int i = tid; i < kTile * rpr; i += kThreads) {
            const int row = quot(i, rpr_m), c = i - row * rpr;
            const bool ok = row < valid;
            cp16(rp + row * RPS + 16 * c,
                 krope + (static_cast<long long>(b) * S_raw + t0
                          + (ok ? row : 0)) * p + 8 * c, ok);
        }
        // the scales: one contiguous run, copied in 4-byte words from its
        // start rounded down to 4 bytes (the first word's lead is skipped
        // when read)
        uint8_t* sc = rp + kTile * RPS;
        const uintptr_t a = reinterpret_cast<uintptr_t>(
            c4_sc + (row0 + t0) * n_sc);
        const uintptr_t al = a & ~static_cast<uintptr_t>(3);
        const int words = static_cast<int>(
            (a - al + 2 * valid * n_sc + 3) / 4);
        for (int i = tid; i < words; i += kThreads)
            cp4(sc + 4 * i, reinterpret_cast<const void*>(al + 4 * i));
    };

    // q (float32, 16 rows of r then 16 of p, heads H..15 zeros) by
    // cp.async into the latent tile's space, which the first
    // dequantization overwrites only after q is read out; with the first
    // two tiles
    float* qs = reinterpret_cast<float*>(ct);
    float* qr = qs + kHeads * (r + 4);
    {
        const int cl = r / 4, cr = p / 4;
        for (int i = tid; i < kHeads * (cl + cr); i += kThreads) {
            const bool rope_row = i >= kHeads * cl;
            const int j = rope_row ? i - kHeads * cl : i;
            const int n = rope_row ? cr : cl;
            const int h = j / n, c = j - h * n;
            const float* src = rope_row ? q_rope : q_lat;
            const int w = rope_row ? p : r;
            cp16((rope_row ? qr + h * (p + 4) : qs + h * (r + 4)) + 4 * c,
                 src + (static_cast<long long>(b) * H + (h < H ? h : 0)) * w
                     + 4 * c,
                 h < H);
        }
    }
    if (t_begin < t_end) issue(t_begin, 0);
    cp_commit();
    if (t_begin + kTile < t_end) issue(t_begin + kTile, 1);
    cp_commit();
    cp_wait_prev();
    __syncthreads();           // q and the first tile are in

    // q of this warp's slice as bf16 A fragments in the tile's feature
    // order: q_hi, and where q is not bf16-exact (never on the serving
    // path) q_lo and q_lo2 as well
    uint32_t qh[4][4], ql[4][4], ql2[4][4], rh[4], rl[4], rl2[4];
    // a0 (row g, k 2t, 2t+1), a1 (g+8), a2 (g, k 8+2t, 9+2t), a3 (g+8):
    // positions 2t, 2t+1 hold features t, t+4 of the latent, 2t, 2t+1 of
    // the RoPE key
    auto q_lat_at = [&](int kk, int j, int e) {
        const int h = (j & 1) ? g + 8 : g;
        const int f = fw + 16 * kk + 8 * (j >> 1) + t4 + 4 * e;
        return lat ? qs[h * (r + 4) + f] : 0.0f;
    };
    auto q_rope_at = [&](int j, int e) {
        const int h = (j & 1) ? g + 8 : g;
        const int f = 16 * warp + 8 * (j >> 1) + 2 * t4 + e;
        return rope ? qr[h * (p + 4) + f] : 0.0f;
    };
    bool inexact = false;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float x = q_lat_at(kk, j, 0), y = q_lat_at(kk, j, 1);
            const uint16_t xh = bf16_bits(x), yh = bf16_bits(y);
            qh[kk][j] = pack(xh, yh);
            inexact |= x != bf16_value(xh) || y != bf16_value(yh);
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const float x = q_rope_at(j, 0), y = q_rope_at(j, 1);
        const uint16_t xh = bf16_bits(x), yh = bf16_bits(y);
        rh[j] = pack(xh, yh);
        inexact |= x != bf16_value(xh) || y != bf16_value(yh);
    }
    // warp-uniform, and a branch (not predication): the q_lo and q_lo2
    // products run only for a q that is not bf16-exact
    const bool need_lo = __any_sync(0xffffffffu, inexact);
    if (__builtin_expect(need_lo, 0)) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                split3(q_lat_at(kk, j, 0), q_lat_at(kk, j, 1), &qh[kk][j],
                       &ql[kk][j], &ql2[kk][j]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
            split3(q_rope_at(j, 0), q_rope_at(j, 1), &rh[j], &rl[j], &rl2[j]);
    }
    __syncthreads();           // q is read out: the tile's space is free

    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    // softmax state of head (tid >> 4), held by its 16 threads alike
    const int sh = tid >> 4, sq = tid & 15;
    float m_run = kNegInf, l_run = 0.0f;

    for (int t0 = t_begin, it = 0; t0 < t_end; t0 += kTile, ++it) {
        const int st = it & 1;
        const uint8_t* base = ring + st * STAGE;
        const uint8_t* rp = base + kTile * PKS;
        const uint8_t* sc = rp + kTile * RPS;
        const int valid = min(kTile, t_end - t0);
        if (it > 0) {
            cp_wait_prev();
            __syncthreads();   // the tile is in; the last tile is consumed
        }

        // ---- dequantize this warp's 64 features of the 64 tokens ----
        if (lat) {
            const int lead = static_cast<int>(
                reinterpret_cast<uintptr_t>(c4_sc + (row0 + t0) * n_sc) & 3);
            const __nv_bfloat16* scs =
                reinterpret_cast<const __nv_bfloat16*>(sc + lead);
#pragma unroll 1
            for (int k = 0; k < 4; ++k) {
                const int u = lane + 32 * k;
                const int row = u >> 1, hf = u & 1;
                const int f0 = fw + 32 * hf;
                uint4* dst = reinterpret_cast<uint4*>(ct + row * CS + f0);
                if (row >= valid) {
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        dst[j] = make_uint4(0u, 0u, 0u, 0u);
                    continue;
                }
                const uint4 w = *reinterpret_cast<const uint4*>(
                    base + row * PKS + f0 / 2);
                const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
                const __nv_bfloat16* srow = scs + row * n_sc;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int f = f0 + 8 * j;
                    uint32_t s[4];
                    if (word_scale) {
                        const uint16_t v = __bfloat16_as_ushort(
                            srow[quot(f, grp_m)]);
                        s[0] = s[1] = s[2] = s[3] = pack(v, v);
                    } else {
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            s[e] = pack(
                                __bfloat16_as_ushort(
                                    srow[quot(f + e, grp_m)]),
                                __bfloat16_as_ushort(
                                    srow[quot(f + e + 4, grp_m)]));
                    }
                    dst[j] = deq_word(ws[j], s[0], s[1], s[2], s[3]);
                }
            }
            __syncwarp();
        }

        // ---- this warp's partial scores: 16 heads x 64 tokens ----
        float sacc[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
            sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.0f;
        const int mi = lane >> 3, mr = lane & 7;
        // the latent's products with one term of q, and the RoPE key's
        auto lat_scores = [&](const uint32_t (&a)[4][4]) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
                for (int np = 0; np < 4; ++np) {
                    // m0: tokens 16np + 0..7, k 0..7; m1: k 8..15;
                    // m2, m3: tokens 16np + 8..15
                    uint32_t bb[4];
                    ldsm_x4(bb, ct + (16 * np + (mi >> 1) * 8 + mr) * CS
                                    + fw + 16 * kk + (mi & 1) * 8);
                    mma(sacc[2 * np], a[kk], bb[0], bb[1]);
                    mma(sacc[2 * np + 1], a[kk], bb[2], bb[3]);
                }
            }
        };
        auto rope_scores = [&](const uint32_t (&a)[4]) {
            const __nv_bfloat16* kr =
                reinterpret_cast<const __nv_bfloat16*>(rp);
            const int rs = RPS / 2;
#pragma unroll
            for (int np = 0; np < 4; ++np) {
                uint32_t bb[4];
                ldsm_x4(bb, kr + (16 * np + (mi >> 1) * 8 + mr) * rs
                                + 16 * warp + (mi & 1) * 8);
                mma(sacc[2 * np], a, bb[0], bb[1]);
                mma(sacc[2 * np + 1], a, bb[2], bb[3]);
            }
        };
        if (lat) lat_scores(qh);
        if (rope) rope_scores(rh);
        if (__builtin_expect(need_lo, 0)) {
            if (lat) {
                lat_scores(ql);
                lat_scores(ql2);
            }
            if (rope) {
                rope_scores(rl);
                rope_scores(rl2);
            }
        }
        if (warp < nsw) {
            float* rw = red + warp * kHeads * kRedStride;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int c = 8 * j + 2 * t4;
                *reinterpret_cast<float2*>(rw + g * kRedStride + c) =
                    make_float2(sacc[j][0], sacc[j][1]);
                *reinterpret_cast<float2*>(rw + (g + 8) * kRedStride + c) =
                    make_float2(sacc[j][2], sacc[j][3]);
            }
        }
        __syncthreads();       // partial scores in; the stage is consumed
        if (t0 + 2 * kTile < t_end) issue(t0 + 2 * kTile, st);
        cp_commit();

        // ---- the tile's online softmax: head sh, tokens 4sq .. 4sq+3 ----
        {
            float4 s = *reinterpret_cast<const float4*>(
                red + sh * kRedStride + 4 * sq);
            for (int w = 1; w < nsw; ++w) {
                const float4 x = *reinterpret_cast<const float4*>(
                    red + (w * kHeads + sh) * kRedStride + 4 * sq);
                s.x += x.x;
                s.y += x.y;
                s.z += x.z;
                s.w += x.w;
            }
            const int tk = 4 * sq;
            const float x0 = tk < valid ? s.x * scale : -INFINITY;
            const float x1 = tk + 1 < valid ? s.y * scale : -INFINITY;
            const float x2 = tk + 2 < valid ? s.z * scale : -INFINITY;
            const float x3 = tk + 3 < valid ? s.w * scale : -INFINITY;
            float mx = fmaxf(fmaxf(x0, x1), fmaxf(x2, x3));
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            // token 0 of a tile is always valid: mx is finite
            const float m_new = fmaxf(m_run, mx);
            const float corr = expf(m_run - m_new);
            const float e0 = expf(x0 - m_new), e1 = expf(x1 - m_new);
            const float e2 = expf(x2 - m_new), e3 = expf(x3 - m_new);
            float sum = (e0 + e1) + (e2 + e3);
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            l_run = l_run * corr + sum;
            m_run = m_new;
            uint32_t hi[2], lo[2];
            split2(e0, e1, &hi[0], &lo[0]);
            split2(e2, e3, &hi[1], &lo[1]);
            *reinterpret_cast<uint2*>(p_hi + sh * kPStride + tk) =
                make_uint2(hi[0], hi[1]);
            *reinterpret_cast<uint2*>(p_lo + sh * kPStride + tk) =
                make_uint2(lo[0], lo[1]);
            if (sq == 0) corr_s[sh] = corr;
        }
        __syncthreads();       // p and the rescale factors in

        // ---- acc: this warp's 16 x 64 fragment, rescaled, += P . C ----
        if (lat) {
            const float c0 = corr_s[g], c1 = corr_s[g + 8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                acc[j][0] *= c0;
                acc[j][1] *= c0;
                acc[j][2] *= c1;
                acc[j][3] *= c1;
            }
#pragma unroll
            for (int kt = 0; kt < 4; ++kt) {
                // A: m0 rows 0..7, k 0..7; m1 rows 8..15; m2, m3 k 8..15
                uint32_t ah[4], alo[4];
                const int pr = (mi & 1) * 8 + mr, pc = 16 * kt + (mi >> 1) * 8;
                ldsm_x4(ah, p_hi + pr * kPStride + pc);
                ldsm_x4(alo, p_lo + pr * kPStride + pc);
#pragma unroll
                for (int jp = 0; jp < 4; ++jp) {
                    // B (transposed): m0 tokens 0..7 of the k-step,
                    // features 16jp + 0..7; m1 tokens 8..15; m2, m3
                    // features + 8
                    uint32_t bb[4];
                    ldsm_x4_t(bb, ct + (16 * kt + (mi & 1) * 8 + mr) * CS
                                      + fw + 16 * jp + (mi >> 1) * 8);
                    mma(acc[2 * jp], ah, bb[0], bb[1]);
                    mma(acc[2 * jp], alo, bb[0], bb[1]);
                    mma(acc[2 * jp + 1], ah, bb[2], bb[3]);
                    mma(acc[2 * jp + 1], alo, bb[2], bb[3]);
                }
            }
        }
    }

    // this block's partial: (b, split) of (B, nsplit, H[, r]); acc goes
    // through shared memory (the partial scores' space, rows padded by 4)
    // so that it leaves in 16-byte stores, row after row
    const long long part = static_cast<long long>(b) * nsplit + split;
    if (sq == 0 && sh < H) {
        m_out[part * H + sh] = m_run;
        l_out[part * H + sh] = l_run;
    }
    __syncthreads();           // every warp is past its last red read
    float* os = red;
    const int OS = r + 4;
    if (lat) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            // positions 2t, 2t+1 of n-tile j hold features t, t+4
            const int f = fw + 8 * j + t4;
            os[g * OS + f] = acc[j][0];
            os[g * OS + f + 4] = acc[j][1];
            os[(g + 8) * OS + f] = acc[j][2];
            os[(g + 8) * OS + f + 4] = acc[j][3];
        }
    }
    __syncthreads();
    const int nq = r / 4;
    const uint32_t nq_m = quot_magic(nq);
    float4* dst = reinterpret_cast<float4*>(acc_out + part * H * r);
    for (int i = tid; i < H * nq; i += kThreads) {
        const int h = quot(i, nq_m), c = i - h * nq;
        dst[i] = *reinterpret_cast<const float4*>(os + h * OS + 4 * c);
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

// one block per (128 features, head, batch row): the splits' partials
// rescaled to their common max and summed in a fixed order: each thread
// takes 4 features of every 8th split, then the 8 sums are added in order
constexpr int kMergeCols = 32;                 // float4 columns a block
constexpr int kMergeGroups = kMergeThreads / kMergeCols;

__global__ void __launch_bounds__(kMergeThreads)
latent_merge_kernel(const float* __restrict__ m_part,
                    const float* __restrict__ l_part,
                    const float* __restrict__ acc_part,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    float* __restrict__ acc_out, int nsplit, int H, int r) {
    extern __shared__ float cs[];                      // nsplit
    __shared__ float red[kMergeThreads / 32];
    __shared__ float4 sums[kMergeThreads];
    const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x;
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
    const int col = chunk * kMergeCols + tid % kMergeCols;
    const int sg = tid / kMergeCols;
    const bool ok = col < r / 4;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (ok) {
#pragma unroll 4
        for (int s = sg; s < nsplit; s += kMergeGroups) {
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
    if (sg == 0 && ok) {
        for (int o = 1; o < kMergeGroups; ++o) {
            const float4 x = sums[o * kMergeCols + tid];
            a.x += x.x;
            a.y += x.y;
            a.z += x.z;
            a.w += x.w;
        }
        reinterpret_cast<float4*>(
            acc_out + (static_cast<long long>(b) * H + h) * r)[col] = a;
    }
    if (tid == 0 && chunk == 0) {
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
    if (B < 1 || B > 65535) return -6;      // the merge's grid z
    // the wrapper's plan: ceil(dense_len / split_tokens) splits, at least
    // one, whole tiles of 64 tokens, and partial buffers wherever there
    // are several
    if (split_tokens < kTile || split_tokens % kTile != 0
        || nsplit != (dense_len > 0 ? (dense_len + split_tokens - 1)
                                          / split_tokens : 1)
        || nsplit > 12288
        || (nsplit > 1 && (!m_part || !l_part || !acc_part)))
        return -7;
    // q, latent and RoPE rows go by 16-byte copies; acc is written and
    // read 16 bytes at a time
    if ((reinterpret_cast<uintptr_t>(c4) | reinterpret_cast<uintptr_t>(krope)
         | reinterpret_cast<uintptr_t>(q_lat)
         | reinterpret_cast<uintptr_t>(q_rope)) & 15u)
        return -8;
    if ((reinterpret_cast<uintptr_t>(c4_sc) & 1u)
        || ((reinterpret_cast<uintptr_t>(acc)
             | reinterpret_cast<uintptr_t>(acc_part)) & 15u))
        return -8;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool merge = nsplit > 1;
    const size_t smem = split_smem(r, p, group);
    static size_t smem_set = 48 * 1024;      // the default limit
    if (smem > smem_set) {
        cudaError_t e = cudaFuncSetAttribute(
            latent_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
        smem_set = smem;
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
    latent_merge_kernel<<<dim3((r / 4 + kMergeCols - 1) / kMergeCols, H, B),
                          kMergeThreads, sizeof(float) * nsplit, st>>>(
        static_cast<const float*>(m_part), static_cast<const float*>(l_part),
        static_cast<const float*>(acc_part), static_cast<float*>(m),
        static_cast<float*>(l), static_cast<float*>(acc), nsplit, H, r);
    return static_cast<int>(cudaGetLastError());
}
