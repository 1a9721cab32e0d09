// host_tier.cu — the host-tier block cache in front of the SSD simulator,
// a whole grid's host cells in one launch, written for Hopper (sm_90a).
//
// There is no TPU kernel behind it: the reference package runs its host
// tier inside the composed `lax.scan` step (src/repro/hostcache/
// pipeline.py:55-275), where each trace op first decides hit, miss,
// insert, evict and flush from the tier's own set-associative state and
// then drives the device core over K = 2 + flush_per_op sub-op slots.
// Nothing the tier decides reads the device, so the port runs it as a pass
// of its own: this kernel turns each cell's trace into its device-visible
// sub-op stream, which the `ssd_step` kernel then runs as a per-op stream
// (K = 1), interior pads and all.
//
// Bound: the chain. A cell is a serial recurrence (each op's lookup reads
// the state the previous op wrote), so a cell's time is its ops times the
// latency of one op's dependent steps; the bytes (the trace in, K sub-ops
// out) are far below. A clock64 probe of a form with one thread
// stepping each cell split an op of the hostcache grid (131,072 ops, 8
// ways, 2 flush slots) into some 600 cycles of flush scan, 400 of set
// scan and row update, 60 of promotion filter, 70 of stores and 8 of
// waiting on the op's inputs: the scans, one way after another, were
// most of the op.
//
// Design: one warp a cell, its lanes the ways. The state — `tag`,
// `dirty`, `age` (sets x ways, int32) and the promotion filter's
// `shadow_tag`/`shadow_cnt` (sets) — lives in dynamic shared memory when
// every such cell of the launch fits the wrapper's budget (13,312 bytes at
// the default 128 x 8); a cell whose geometry does not fit works on its
// own state in device memory (the output buffer, filled from the input
// first), in the same kernel. Mode, promotion, flush scheduling, sets,
// ways and flush_per_op come from each cell's descriptor at run time, so
// every spec of a grid shares the launch. Per op, for the common way
// counts (2, 4, 8, 16: template instances, the one-round form):
// - one round of loads: lane w < W reads way w of the op's set (tag, age,
//   dirty), and the lanes in segments of W read the first 32 / W flush
//   sets (fcur, fcur + 1, ...), all before anything is decided;
// - the lookup, four independent collectives: the first hit way is the
//   lowest bit of a ballot, the dirty and valid flags two more ballots,
//   and the first oldest way the warp's least (age << 5 | way) by one
//   `__reduce_min_sync` (ages stay below 2^26: `run_tier` gives a cell
//   whose ticks would not to the generic form);
// - the decisions (promotion, insert, eviction, absorption, the dirty
//   count, the flush latch) are the same scalar code in every lane;
// - the row update is stored by the lane that owns the way (the victim's
//   lane also writes slot 1's lba, its tag), and the flush lanes whose
//   set is the op's own apply the same update to what they read, so the
//   flush scan needs no second round of loads;
// - the flush scan, when a flush is on: each set's first oldest dirty way
//   is its least (age << 5 | lane) over its segment, one reduction a set;
//   the lane that holds it clears the dirty flag and writes the set's
//   slot, the segment's first lane writes it where nothing fires. With
//   F x W > 32 the further flush sets go in later rounds, each its own
//   loads. When no flush is on the slots are written without a scan;
// - slot 0, the absorbed flag and, when asked, the host row (the eight
//   cumulative counters and the dirty fraction, by nine lanes); the
//   output pointers step one op at a time.
// The trace's inputs, and each op's set index, are staged by the whole
// warp into shared memory, 128 ops at a time, the next chunk loaded into
// registers while this one steps, so no op waits on device memory; the
// next op's inputs are read one op ahead. Any other way count takes the
// generic form: the set scanned by lanes in chunks of 32, the flush sets
// one after another. The set index is a multiply-high by a magic number,
// not a division. What remains is the op's chain of scalar decisions and
// stores, issued by one warp: on the hostcache grid the op went from some
// 1,090 cycles to some 840, its flush scan from 600 to 260 (PERF.md).
//
// Bit identity with the reference's compiled step: the ties and order of
// `ref.py` (the first hit way, the first oldest way as victim, the first
// oldest dirty way of a flush set, distinct flush sets round robin, the
// watermark latch recomputed on pads too, the idle flush off in closed
// loop); the watermark products `wm * lines` and the dirty fraction's
// product with float32(1 / lines) (the compiled reference multiplies by
// the reciprocal of this constant, ROADMAP §C), computed by the wrapper and
// passed in; built with -fmad=false so nothing is fused.
//
// The recurrence is plain C++ marked host and device, written over a small
// lane abstraction (`Lanes`, `ballot`, `min_all`): on the card a
// `Lanes<T>` is one register of each thread and the collectives are the
// warp's; built for the CPU (`host_tier_run_host`, with a host C++ compiler
// when no nvcc is present) it is an array of 32 and the collectives are
// loops over it. That is how the tests check this file's warp arithmetic
// against the plain version on a machine without a card.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HT_FN __host__ __device__ __forceinline__
#else
#define HT_FN inline
#endif
#include <stdint.h>
#include <string.h>

namespace {

// descriptor of one cell: N_DESC int64
enum {
  Q_ARRIVAL = 0, Q_LBA, Q_KIND,        // the trace (T,) f32, i32, i32
  Q_SUB_T, Q_SUB_LBA, Q_SUB_KIND,      // the sub-op stream (T*K,)
  Q_ABSORBED,                          // (T,) int8
  Q_ROWS,                              // (T, N_ROW) f32, or 0
  Q_STATE,                             // the cell's offset in the state words
  Q_T, Q_SETS, Q_WAYS, Q_FLUSH_PER_OP,
  Q_MODE, Q_PROMOTE, Q_FLUSH, Q_CLOSED,
  Q_SMEM,                              // 1: state in shared memory
  Q_KNOB_ROW,
  N_DESC
};

// per-cell float knobs: N_KNOB f32
enum { K_PROMOTE_N = 0, K_WM_HI, K_WM_LO, K_FLUSH_GAP, K_LINES, K_LINES_INV,
       N_KNOB };

enum { MODE_WB = 0, MODE_WT = 1, MODE_WA = 2 };
enum { PROMOTE_ALWAYS = 0, PROMOTE_NTH = 1 };
enum { FLUSH_WATERMARK = 0, FLUSH_IDLE = 1 };

constexpr int N_HCTR = 8;
constexpr int N_ROW = N_HCTR + 1;      // the counters, the dirty fraction
// the scalars after a cell's arrays: tick, dirty_n, flushing, fcur, prev_t
// (float bits), hctr (8 float bits)
constexpr int N_SCALARS = 5 + N_HCTR;
constexpr int INT_BIG = 2147483647;
constexpr int BLOCK_THREADS = 32;
constexpr int CHUNK = 128;             // trace ops staged at a time
constexpr unsigned FULL = 0xffffffffu;

HT_FN long long state_words(long long sets, long long ways) {
  return 3 * sets * ways + 2 * sets + N_SCALARS;
}

HT_FN float as_float(int x) {
#ifdef __CUDA_ARCH__
  return __int_as_float(x);
#else
  float f;
  memcpy(&f, &x, 4);
  return f;
#endif
}

HT_FN int as_int(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_int(f);
#else
  int x;
  memcpy(&x, &f, 4);
  return x;
#endif
}

// ---- the lane abstraction: a warp on the card, 32 lanes in a loop on the
// CPU. A value of each lane is a `Lanes<T>`; code inside FOR_LANES(l) is
// one lane's; code outside it is the same in every lane (uniform). ----
#ifdef __CUDA_ARCH__
template <class T>
struct Lanes {
  T v;
  __device__ __forceinline__ T& operator[](int) { return v; }
  __device__ __forceinline__ const T& operator[](int) const { return v; }
};
#define FOR_LANES(l) \
  for (int l = static_cast<int>(threadIdx.x & 31), l##_n = 0; l##_n < 1; \
       ++l##_n)
#else
template <class T>
struct Lanes {
  T v[32];
  T& operator[](int l) { return v[l]; }
  const T& operator[](int l) const { return v[l]; }
};
#define FOR_LANES(l) for (int l = 0; l < 32; ++l)
#endif

// the lanes whose predicate holds, as a bit mask
HT_FN unsigned ballot(const Lanes<bool>& p) {
#ifdef __CUDA_ARCH__
  return __ballot_sync(FULL, p.v);
#else
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= p.v[l] ? 1u << l : 0u;
  return m;
#endif
}

// the minimum over all lanes
HT_FN int min_all(const Lanes<int>& x) {
#ifdef __CUDA_ARCH__
  return __reduce_min_sync(FULL, x.v);
#else
  int m = x.v[0];
  for (int l = 1; l < 32; ++l) m = x.v[l] < m ? x.v[l] : m;
  return m;
#endif
}

// orders the lanes' shared- and device-memory accesses before and after
HT_FN void syncwarp() {
#ifdef __CUDA_ARCH__
  __syncwarp();
#endif
}

HT_FN int first_bit(unsigned m) {       // m != 0
#ifdef __CUDA_ARCH__
  return __ffs(m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

// The probe form (PROBE = true, device only): clock64 stamps around each
// part of an op, summed over the cell's ops into its row of `probe`
// (N_PROBE int64): the wait on the op's inputs (the chunk's staging
// included), the set scan with the row's update (and the first flush
// sets' loads), the promotion filter, the flush scan, the stores. Each
// part ends on a volatile move of its result, so its stamp waits for it.
enum { P_TOTAL = 0, P_WAIT, P_SCAN, P_PROMOTE, P_FLUSH, P_STORE, P_OPS,
       N_PROBE = 8 };

#ifdef __CUDA_ARCH__
__device__ __forceinline__ long long stamp() {
  long long c;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c));
  return c;
}
__device__ __forceinline__ int pin(int x) {
  int y;
  asm volatile("mov.b32 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}
#define HT_STAMP(PROBE, var) \
  if (PROBE) { var = stamp(); }
#define HT_PIN(PROBE, x) \
  if (PROBE) { x = pin(x); }
#else
#define HT_STAMP(PROBE, var)
#define HT_PIN(PROBE, x)
#endif

// `a mod d` for a >= 0 by a multiply-high with a magic number (the
// divisor is a cell's run-time set count, so no compile-time constant
// helps); floor semantics, as Python's and the reference's `%`, for a < 0
struct Mod {
  int d;           // >= 1
  uint32_t m;      // magic multiplier (d > 1)
  int l;           // ceil(log2(d))
};

HT_FN Mod make_mod(int d) {
  Mod v;
  v.d = d;
  v.l = 0;
  while ((1LL << v.l) < d) ++v.l;
  v.m = d > 1 ? static_cast<uint32_t>(
                    ((1ULL << 32) * ((1ULL << v.l) - (unsigned long long)d)) /
                        (unsigned long long)d + 1)
              : 0u;
  return v;
}

HT_FN uint32_t mulhi(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  return __umulhi(a, b);
#else
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) >> 32);
#endif
}

HT_FN int mod(int a, const Mod& v) {
  if (a < 0) {
    const int r = a % v.d;
    return r < 0 ? r + v.d : r;
  }
  if (v.d == 1) return 0;
  const uint32_t un = static_cast<uint32_t>(a);
  const uint32_t t = mulhi(v.m, un);
  const int q = static_cast<int>((t + ((un - t) >> 1)) >> (v.l - 1));
  return a - q * v.d;
}

// What one op does to way w of its set, as `ref.py` updates the row: the
// hit way's age (or, written around, its line dropped; written back, its
// dirty flag), or the inserted victim's line. Returns whether it touched
// the way; the update sets values, so applying it twice is applying it
// once.
struct RowOp {
  int lba, tick, mode;
  bool hit, ins, is_write;
  int way, vic;
};

HT_FN bool apply_row(const RowOp& o, int w, int& tg, int& dv, int& a) {
  if (o.hit && w == o.way) {
    a = o.tick;
    if (o.mode == MODE_WA && o.is_write) {   // superseded by the write
      tg = -1;
      a = 0;
    }
    if (o.mode == MODE_WB && o.is_write) dv = 1;
    return true;
  }
  if (o.ins && w == o.vic) {
    tg = o.lba;
    a = o.tick;
    dv = (o.mode == MODE_WB && o.is_write) ? 1 : 0;
    return true;
  }
  return false;
}

// One cell's whole trace through its host tier, run by one warp (or its
// 32 emulated lanes on the CPU). `arrays` holds the cell's tag | dirty |
// age (sets x ways each), shadow_tag | shadow_cnt (sets): in shared memory
// or in device memory; `scal` the N_SCALARS scalars; `stage` 4 x CHUNK
// words of shared memory for the staged inputs and their set indices. WAYS in {2, 4, 8, 16}
// fixes the way count at compile time (the one-round form); WAYS = 0 reads
// it from the descriptor (the generic form).
template <int WAYS, bool PROBE>
HT_FN void tier_warp(const long long* d, const float* kn, int* arrays,
                     int* scal, long long* probe, int* stage) {
  const float* arrival = reinterpret_cast<const float*>(d[Q_ARRIVAL]);
  const int* lbas = reinterpret_cast<const int*>(d[Q_LBA]);
  const int* kinds = reinterpret_cast<const int*>(d[Q_KIND]);
  float* sub_t = reinterpret_cast<float*>(d[Q_SUB_T]);
  int* sub_lba = reinterpret_cast<int*>(d[Q_SUB_LBA]);
  int* sub_kind = reinterpret_cast<int*>(d[Q_SUB_KIND]);
  int8_t* absorbed_o = reinterpret_cast<int8_t*>(d[Q_ABSORBED]);
  float* rows = reinterpret_cast<float*>(d[Q_ROWS]);
  const long long T = d[Q_T];
  const int S = static_cast<int>(d[Q_SETS]);
  const int W = WAYS > 0 ? WAYS : static_cast<int>(d[Q_WAYS]);
  const int F = static_cast<int>(d[Q_FLUSH_PER_OP]);
  const int K = 2 + F;
  const int mode = static_cast<int>(d[Q_MODE]);
  const bool nth = d[Q_PROMOTE] == PROMOTE_NTH;
  const bool watermark = d[Q_FLUSH] == FLUSH_WATERMARK;
  const bool closed = d[Q_CLOSED] != 0;
  const float promote_n = kn[K_PROMOTE_N];
  // the latch's thresholds: float32 products, as the reference forms them
  const float hi = kn[K_WM_HI] * kn[K_LINES];
  const float lo = kn[K_WM_LO] * kn[K_LINES];
  const float flush_gap = kn[K_FLUSH_GAP];
  const float lines_inv = kn[K_LINES_INV];
  const Mod sets = make_mod(S);

  int* tag = arrays;
  int* dirty = tag + S * W;
  int* age = dirty + S * W;
  int* sh_tag = age + S * W;
  int* sh_cnt = sh_tag + S;
  float* st_t = reinterpret_cast<float*>(stage);
  int* st_lba = stage + CHUNK;
  int* st_kind = stage + 2 * CHUNK;
  int* st_si = stage + 3 * CHUNK;

  int tick = scal[0], dirty_n = scal[1], flushing = scal[2], fcur = scal[3];
  float prev_t = as_float(scal[4]);
  float hctr[N_HCTR];
  for (int i = 0; i < N_HCTR; ++i) hctr[i] = as_float(scal[5 + i]);
  // the one-round form (a way count fixed at compile time) packs (age,
  // lane) into one int, age << 5 | lane: `run_tier` gives it only cells
  // whose ticks stay below 2^26
  constexpr bool packed = WAYS > 0;
  // flush sets a round scans: one a segment of W lanes
  const int spr = packed ? 32 / (packed ? WAYS : 1) : 1;

  long long c0 = 0, c1 = 0, c2 = 0, c3 = 0, c4 = 0, c5 = 0, c6 = 0;
  long long p_sum[N_PROBE] = {0, 0, 0, 0, 0, 0, 0, 0};
  long long c_start = 0;
  HT_STAMP(PROBE, c_start);

  // a chunk of the trace into registers (CHUNK / 32 ops a lane), then into
  // the stage with each op's set index
  Lanes<float> nx_t[CHUNK / 32];
  Lanes<int> nx_lba[CHUNK / 32], nx_kind[CHUNK / 32];
#define HT_FETCH(base)                                  \
  FOR_LANES(l) {                                        \
    _Pragma("unroll")                                   \
    for (int j = 0; j < CHUNK / 32; ++j) {              \
      const long long ix = (base) + l + 32 * j;         \
      nx_t[j][l] = ix < T ? arrival[ix] : 0.0f;         \
      nx_lba[j][l] = ix < T ? lbas[ix] : 0;             \
      nx_kind[j][l] = ix < T ? kinds[ix] : -1;          \
    }                                                   \
  }
#define HT_PUT()                                        \
  FOR_LANES(l) {                                        \
    _Pragma("unroll")                                   \
    for (int j = 0; j < CHUNK / 32; ++j) {              \
      st_t[l + 32 * j] = nx_t[j][l];                    \
      st_lba[l + 32 * j] = nx_lba[j][l];                \
      st_kind[l + 32 * j] = nx_kind[j][l];              \
      st_si[l + 32 * j] = mod(nx_lba[j][l], sets);      \
    }                                                   \
  }                                                     \
  syncwarp();
  HT_FETCH(0)
  HT_PUT()

  for (long long base = 0; base < T; base += CHUNK) {
    const int n = T - base < CHUNK ? static_cast<int>(T - base) : CHUNK;
    if (base + CHUNK < T) {            // in flight while this chunk steps
      HT_FETCH(base + CHUNK)
    }
    // each op's inputs one op ahead
    float n_t = st_t[0];
    int n_lba = st_lba[0], n_kind = st_kind[0], n_si = st_si[0];
    for (int k = 0; k < n; ++k) {
      HT_STAMP(PROBE, c0);
      float t = n_t;
      int lba = n_lba, kind = n_kind, si = n_si;
      if (k + 1 < n) {
        n_t = st_t[k + 1];
        n_lba = st_lba[k + 1];
        n_kind = st_kind[k + 1];
        n_si = st_si[k + 1];
      }
      if (PROBE) {
        int tb = as_int(t);
        HT_PIN(PROBE, tb);
        HT_PIN(PROBE, lba);
        HT_PIN(PROBE, kind);
        HT_PIN(PROBE, si);
        t = as_float(tb);
      }
      HT_STAMP(PROBE, c1);
      const bool live = kind >= 0;
      const bool is_write = kind == 1;
      const bool is_read = live && !is_write;
      int* trow = tag + si * W;
      int* drow = dirty + si * W;
      int* arow = age + si * W;

      // ---- lookup and the LRU victim ----
      bool hit = false, vic_valid = false;
      int way = 0, vic = 0, vic_dirty = 0, hit_dirty = 0, vic_tag = 0;
      // the one-round form: this op's set and the first flush sets
      Lanes<int> ltg, lag, ldr, ftg, fag, fdr, fset;
      const int nf0 = F < spr ? F : spr;
      if constexpr (packed) {
        FOR_LANES(l) {
          const int w = l & (W - 1);
          int seg = l / W;
          seg = seg < nf0 ? seg : 0;
          int fs = fcur + seg;
          fs = fs >= S ? fs - S : fs;
          fset[l] = fs;
          // every load unconditional: they issue together
          ltg[l] = trow[w];
          lag[l] = arow[w];
          ldr[l] = drow[w];
          ftg[l] = tag[fs * W + w];
          fag[l] = age[fs * W + w];
          fdr[l] = dirty[fs * W + w];
        }
        // four independent collectives: hits, dirty flags, valid tags,
        // and the first oldest way as the least (age << 5 | way)
        Lanes<bool> ph, pd, pv;
        Lanes<int> ka;
        FOR_LANES(l) {
          ph[l] = l < W && live && ltg[l] == lba;
          pd[l] = l < W && ldr[l] > 0;
          pv[l] = l < W && ltg[l] >= 0;
          ka[l] = l < W ? (lag[l] << 5 | l) : INT_BIG;
        }
        const unsigned hm = ballot(ph), dm = ballot(pd), vm = ballot(pv);
        vic = min_all(ka) & 31;
        hit = hm != 0;
        way = hit ? first_bit(hm) : 0;
        vic_dirty = static_cast<int>((dm >> vic) & 1u);
        vic_valid = ((vm >> vic) & 1u) != 0;
        hit_dirty = static_cast<int>((dm >> way) & 1u);
      } else {
        // the generic form: the set in chunks of 32 ways
        int vmin = INT_BIG;
        for (int w0 = 0; w0 < W; w0 += 32) {
          Lanes<bool> ph;
          Lanes<int> ka;
          FOR_LANES(l) {
            const int w = w0 + l;
            const bool ok = w < W;
            const int tg = ok ? trow[w] : -1;
            ka[l] = ok ? arow[w] : INT_BIG;
            ph[l] = ok && live && tg == lba;
          }
          const unsigned hm = ballot(ph);
          if (!hit && hm) {
            hit = true;
            way = w0 + first_bit(hm);
          }
          const int cmin = min_all(ka);
          if (w0 == 0 || cmin < vmin) {
            Lanes<bool> pk;
            FOR_LANES(l) pk[l] = w0 + l < W && ka[l] == cmin;
            vmin = cmin;
            vic = w0 + first_bit(ballot(pk));
          }
        }
        vic_tag = trow[vic];
        vic_valid = vic_tag >= 0;
        vic_dirty = drow[vic];
        hit_dirty = drow[way];
      }
      tick += live ? 1 : 0;
      if (PROBE) {
        int k2 = (hit ? 1 : 0) + 2 * way + 64 * vic + vic_dirty;
        HT_PIN(PROBE, k2);
      }
      HT_STAMP(PROBE, c2);

      // ---- promotion filter ----
      bool promote_ok = live;
      int cnt = 0;
      if (nth) {
        const int sh = sh_cnt[si];
        cnt = sh_tag[si] == lba ? sh + 1 : 1;
        promote_ok = static_cast<float>(cnt) >= promote_n;
      }
      if (PROBE) {
        int k2 = promote_ok ? 1 : 0;
        HT_PIN(PROBE, k2);
        promote_ok = k2 != 0;
      }
      HT_STAMP(PROBE, c3);

      // ---- insert, victim, absorption ----
      const bool want = mode == MODE_WA ? (is_read && !hit) : (live && !hit);
      const bool ins = want && promote_ok;
      const bool evict = ins && vic_dirty > 0 && vic_valid;
      const bool absorbed_w = mode == MODE_WB && is_write && (hit || ins);
      const bool absorbed_r = is_read && hit;
      const bool absorbed = absorbed_r || absorbed_w;
      int d_delta = 0;
      if (hit && mode == MODE_WB && is_write && hit_dirty == 0) ++d_delta;
      if (ins && mode == MODE_WB)
        d_delta += (is_write ? 1 : 0) - (evict ? 1 : 0);
      dirty_n += d_delta;
      const RowOp row_op = {lba, tick, mode, hit, ins, is_write, way, vic};
      // this op's K slots (the pointers step K an op: no 64-bit index
      // arithmetic on the chain)
      float* st = sub_t;
      int* sl = sub_lba;
      int* sk = sub_kind;

      // ---- the row (the hit way, or the inserted victim), and slot 1's
      // lba: the victim's tag, written by the lane that holds it ----
      if constexpr (packed) {
        FOR_LANES(l) {
          int tg = ltg[l], dv = ldr[l], a = lag[l];
          if (evict && l == vic) sl[1] = tg;
          if (l < W && apply_row(row_op, l, tg, dv, a)) {
            trow[l] = tg;
            drow[l] = dv;
            arow[l] = a;
          }
        }
      } else {
        FOR_LANES(l) {
          if (l == 0) {
            if (evict) sl[1] = vic_tag;
            const int ws[2] = {way, vic};
            for (int e = 0; e < 2; ++e) {
              const int w = ws[e];
              int tg = trow[w], dv = drow[w], a = arow[w];
              if (apply_row(row_op, w, tg, dv, a)) {
                trow[w] = tg;
                drow[w] = dv;
                arow[w] = a;
              }
            }
          }
        }
      }
      if (nth && live && !hit) {       // the filter sees misses only
        FOR_LANES(l) {
          if (l == 0) {
            sh_tag[si] = lba;
            sh_cnt[si] = cnt;
          }
        }
      }
      HT_PIN(PROBE, dirty_n);
      HT_STAMP(PROBE, c4);

      // ---- flush scheduling ----
      bool flush_on = false;
      if (mode == MODE_WB && watermark) {
        const float df = static_cast<float>(dirty_n);
        flushing = df >= hi ? 1 : (df <= lo ? 0 : flushing);
        flush_on = flushing == 1 && live;
      } else if (mode == MODE_WB && !closed) {
        float gap = t - prev_t;
        gap = gap > 0.0f ? gap : 0.0f;
        flush_on = live && gap > flush_gap && dirty_n > 0;
      }
      int n_flushed = 0;
      if (!flush_on) {                 // no slot fires: no scan
#pragma unroll 1
        for (int f0 = 0; f0 < F; f0 += 32) {
          FOR_LANES(l) {
            if (f0 + l < F) {
              st[2 + f0 + l] = t;
              sl[2 + f0 + l] = 0;
              sk[2 + f0 + l] = -1;
            }
          }
        }
      } else if constexpr (packed) {
        // rounds of spr flush sets, segment `seg` of W lanes a set; the
        // first round's loads were made with the lookup's. A set's first
        // oldest dirty way is its least (age << 5 | lane) among its dirty
        // lanes: one independent reduction a set. The row update's stores
        // come first (a flushed way may be the row's, in another lane)
        syncwarp();
#pragma unroll 1
        for (int f0 = 0; f0 < F; f0 += spr) {
          const int nf = F - f0 < spr ? F - f0 : spr;
          if (f0 > 0) {
            syncwarp();
            FOR_LANES(l) {
              const int w = l & (W - 1);
              int seg = l / W;
              seg = seg < nf ? seg : 0;
              int fs = fcur + f0 + seg;   // < 2S: fcur < S, f0 + seg < F
              fs = fs >= S ? fs - S : fs;
              fset[l] = fs;
              ftg[l] = tag[fs * W + w];
              fag[l] = age[fs * W + w];
              fdr[l] = dirty[fs * W + w];
            }
          }
          Lanes<int> key;
          FOR_LANES(l) {
            const int w = l & (W - 1);
            int tg = ftg[l], dv = fdr[l], a = fag[l];
            if (fset[l] == si) apply_row(row_op, w, tg, dv, a);
            ftg[l] = tg;
            key[l] = (l / W < nf && dv > 0) ? (a << 5 | l) : INT_BIG;
          }
          Lanes<int> mine;
          FOR_LANES(l) mine[l] = INT_BIG;
#pragma unroll
          for (int s = 0; s < (WAYS > 0 ? 32 / WAYS : 1); ++s) {
            if (s < nf) {
              Lanes<int> ks;
              FOR_LANES(l) ks[l] = l / W == s ? key[l] : INT_BIG;
              const int m = min_all(ks);
              n_flushed += m < INT_BIG ? 1 : 0;
              FOR_LANES(l) mine[l] = l / W == s ? m : mine[l];
            }
          }
          FOR_LANES(l) {
            const int w = l & (W - 1), seg = l / W;
            if (seg < nf) {
              const bool has = mine[l] < INT_BIG;
              if (has && (mine[l] & 31) == l) {    // the flushed way
                dirty[fset[l] * W + w] = 0;
                st[2 + f0 + seg] = t;
                sl[2 + f0 + seg] = ftg[l];
                sk[2 + f0 + seg] = 1;
              } else if (!has && w == 0) {
                st[2 + f0 + seg] = t;
                sl[2 + f0 + seg] = 0;
                sk[2 + f0 + seg] = -1;
              }
            }
          }
        }
      } else {
        // the generic form: one flush set after another, in chunks of 32
        syncwarp();
        int fs = fcur;
        for (int f = 0; f < F; ++f, fs = fs + 1 == S ? 0 : fs + 1) {
          int kmin = INT_BIG, fw = 0;
          for (int w0 = 0; w0 < W; w0 += 32) {
            Lanes<int> key;
            FOR_LANES(l) {
              const int w = w0 + l;
              key[l] = (w < W && dirty[fs * W + w] > 0) ? age[fs * W + w]
                                                        : INT_BIG;
            }
            const int cmin = min_all(key);
            if (cmin < kmin) {
              Lanes<bool> pk;
              FOR_LANES(l) pk[l] = w0 + l < W && key[l] == cmin;
              kmin = cmin;
              fw = w0 + first_bit(ballot(pk));
            }
          }
          const bool do_flush = kmin < INT_BIG;
          const int ftag = tag[fs * W + fw];
          syncwarp();
          FOR_LANES(l) {
            if (l == 0) {
              if (do_flush) dirty[fs * W + fw] = 0;
              st[2 + f] = t;
              sl[2 + f] = do_flush ? ftag : 0;
              sk[2 + f] = do_flush ? 1 : -1;
            }
          }
          n_flushed += do_flush ? 1 : 0;
          syncwarp();
        }
      }
      dirty_n -= n_flushed;
      if (flush_on) {                  // (fcur + F) mod S, F < S
        fcur += F;
        if (fcur >= S) fcur -= S;
      }
      HT_PIN(PROBE, dirty_n);
      HT_STAMP(PROBE, c5);

      // ---- slot 0 (the op, or a pad), slot 1 (the write-back), the
      // flag, the counters and the row ----
      hctr[0] += hit ? 1.0f : 0.0f;
      hctr[1] += absorbed_r ? 1.0f : 0.0f;
      hctr[2] += (hit && is_write) ? 1.0f : 0.0f;
      hctr[3] += absorbed ? 1.0f : 0.0f;
      hctr[4] += absorbed_w ? 1.0f : 0.0f;
      hctr[5] += (live && !absorbed) ? 1.0f : 0.0f;
      hctr[6] += static_cast<float>(n_flushed);
      hctr[7] += evict ? 1.0f : 0.0f;
      if (live) prev_t = t;
      FOR_LANES(l) {
        if (l == 0) {
          st[0] = t;
          sl[0] = absorbed ? 0 : lba;
          sk[0] = absorbed ? -1 : kind;
          *absorbed_o = absorbed ? 1 : 0;
        }
        if (l == 1) {
          st[1] = t;
          if (!evict) sl[1] = 0;
          sk[1] = evict ? 1 : -1;
        }
        if (rows && l < N_ROW) {
          float v = static_cast<float>(dirty_n) * lines_inv;
          for (int j = 0; j < N_HCTR; ++j) v = l == j ? hctr[j] : v;
          rows[l] = v;
        }
      }
      sub_t += K;
      sub_lba += K;
      sub_kind += K;
      ++absorbed_o;
      if (rows) rows += N_ROW;
      // this op's stores before the next op's loads, in every lane
      syncwarp();
      if (PROBE) {
        HT_STAMP(PROBE, c6);
        p_sum[P_WAIT] += c1 - c0;
        p_sum[P_SCAN] += (c2 - c1) + (c4 - c3);
        p_sum[P_PROMOTE] += c3 - c2;
        p_sum[P_FLUSH] += c5 - c4;
        p_sum[P_STORE] += c6 - c5;
      }
    }
    if (base + CHUNK < T) {            // the next chunk into the stage
      HT_STAMP(PROBE, c0);
      HT_PUT()
      if (PROBE) {
        HT_STAMP(PROBE, c1);
        p_sum[P_WAIT] += c1 - c0;
      }
    }
  }
  if (PROBE) {
    long long c_end = 0;
    HT_STAMP(PROBE, c_end);
    p_sum[P_TOTAL] = c_end - c_start;
    p_sum[P_OPS] = T;
    FOR_LANES(l) {
      if (l == 0)
        for (int k = 0; k < N_PROBE; ++k) probe[k] = p_sum[k];
    }
  }
  FOR_LANES(l) {
    if (l == 0) {
      scal[0] = tick;
      scal[1] = dirty_n;
      scal[2] = flushing;
      scal[3] = fcur;
      scal[4] = as_int(prev_t);
      for (int j = 0; j < N_HCTR; ++j) scal[5 + j] = as_int(hctr[j]);
    }
  }
}

#undef HT_FETCH
#undef HT_PUT

// a cell's recurrence, specialised to its way count where it is one of the
// common ones and its ticks stay below 2^26 (the one-round form's packed
// keys); the generic form otherwise
template <bool PROBE>
HT_FN void run_tier(const long long* d, const float* kn, int* arrays,
                    int* scal, long long* probe, int* stage) {
  if (static_cast<long long>(scal[0]) + d[Q_T] >= (1LL << 26)) {
    tier_warp<0, PROBE>(d, kn, arrays, scal, probe, stage);
    return;
  }
  switch (d[Q_WAYS]) {
    case 2: tier_warp<2, PROBE>(d, kn, arrays, scal, probe, stage); break;
    case 4: tier_warp<4, PROBE>(d, kn, arrays, scal, probe, stage); break;
    case 8: tier_warp<8, PROBE>(d, kn, arrays, scal, probe, stage); break;
    case 16: tier_warp<16, PROBE>(d, kn, arrays, scal, probe, stage); break;
    default: tier_warp<0, PROBE>(d, kn, arrays, scal, probe, stage);
  }
}

// Refuse what the recurrence does not take; 0 when `d` is well formed.
HT_FN int check_desc(const long long* d) {
  if (d[Q_T] < 0 || d[Q_SETS] < 1 || d[Q_WAYS] < 1 ||
      d[Q_FLUSH_PER_OP] < 1 || d[Q_FLUSH_PER_OP] >= d[Q_SETS])
    return -2;
  if (d[Q_MODE] < MODE_WB || d[Q_MODE] > MODE_WA || d[Q_PROMOTE] < 0 ||
      d[Q_PROMOTE] > 1 || d[Q_FLUSH] < 0 || d[Q_FLUSH] > 1 ||
      d[Q_STATE] < 0 || d[Q_KNOB_ROW] < 0)
    return -2;
  if (d[Q_T] > 0 && (d[Q_ARRIVAL] == 0 || d[Q_LBA] == 0 || d[Q_KIND] == 0 ||
                     d[Q_SUB_T] == 0 || d[Q_SUB_LBA] == 0 ||
                     d[Q_SUB_KIND] == 0 || d[Q_ABSORBED] == 0))
    return -3;
  return 0;
}

}  // namespace

#ifdef __CUDACC__

template <bool PROBE>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
    host_tier_kernel(const long long* desc, const float* knobs,
                     const int* state_in, int* state_out, long long* probe) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int stage[4 * CHUNK];
  const long long* d = desc + (size_t)blockIdx.x * N_DESC;
  const long long words = state_words(d[Q_SETS], d[Q_WAYS]);
  const long long n_arr = words - N_SCALARS;
  const int* in = state_in + d[Q_STATE];
  int* out = state_out + d[Q_STATE];
  // the arrays: into shared memory, or copied to the output buffer and
  // worked on there; the scalars in the output buffer either way
  int* arrays = d[Q_SMEM] ? smem : out;
  for (long long i = threadIdx.x; i < words; i += blockDim.x) {
    if (i < n_arr) arrays[i] = in[i];
    else out[i] = in[i];
  }
  __syncthreads();
  // two call sites, so that in the first the compiler knows the arrays
  // are shared memory: their loads are then free to issue ahead of the
  // recurrence's stores to device memory (through a generic pointer that
  // may alias those stores they are not)
  const float* kn = knobs + d[Q_KNOB_ROW] * N_KNOB;
  long long* pr = PROBE ? probe + (size_t)blockIdx.x * N_PROBE : nullptr;
  if (d[Q_SMEM]) run_tier<PROBE>(d, kn, smem, out + n_arr, pr, stage);
  else run_tier<PROBE>(d, kn, out, out + n_arr, pr, stage);
  __syncthreads();
  if (arrays != out)
    for (long long i = threadIdx.x; i < n_arr; i += blockDim.x)
      out[i] = arrays[i];
}

extern "C" {

// Launch on `stream`: C blocks (one warp each), block b running
// descriptor row b. `desc` (C, N_DESC) int64 and `knobs` (rows, N_KNOB)
// f32 on the device, `desc_host` the same descriptors on the host
// (checked here); `state_in`/`state_out` the cells' state words;
// `smem_bytes` the dynamic shared memory of a block (the largest
// shared-memory cell's arrays); `probe`, when not null, (C, N_PROBE)
// int64 for the probe form. Returns 0, cudaGetLastError() of the launch,
// or a negative code for refused arguments.
int host_tier_launch(const long long* desc, const float* knobs,
                     const int* state_in, int* state_out, int n_cells,
                     int smem_bytes, const long long* desc_host,
                     long long* probe, unsigned long long stream) {
  if (n_cells <= 0 || desc == nullptr || knobs == nullptr ||
      state_in == nullptr || state_out == nullptr || desc_host == nullptr ||
      smem_bytes < 0)
    return -1;
  for (int c = 0; c < n_cells; ++c) {
    const long long* d = desc_host + (size_t)c * N_DESC;
    const int rc = check_desc(d);
    if (rc) return rc;
    if (d[Q_SMEM] &&
        4 * (state_words(d[Q_SETS], d[Q_WAYS]) - N_SCALARS) > smem_bytes)
      return -4;
  }
  auto kernel = probe ? host_tier_kernel<true> : host_tier_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_cells, BLOCK_THREADS, smem_bytes,
           reinterpret_cast<cudaStream_t>(stream)>>>(desc, knobs, state_in,
                                                     state_out, probe);
  return (int)cudaGetLastError();
}

}  // extern "C"

#else

extern "C" {

// The same warp recurrence on the CPU, its 32 lanes emulated, cell after
// cell, every pointer a host pointer: the kernel's arithmetic where no
// card is present.
int host_tier_run_host(const long long* desc, const float* knobs,
                       const int* state_in, int* state_out, int n_cells) {
  int stage[4 * CHUNK];
  for (int c = 0; c < n_cells; ++c) {
    const long long* d = desc + (size_t)c * N_DESC;
    const int rc = check_desc(d);
    if (rc) return rc;
    const long long words = state_words(d[Q_SETS], d[Q_WAYS]);
    int* out = state_out + d[Q_STATE];
    memcpy(out, state_in + d[Q_STATE], (size_t)words * 4);
    run_tier<false>(d, knobs + d[Q_KNOB_ROW] * N_KNOB, out,
                    out + words - N_SCALARS, nullptr, stage);
  }
  return 0;
}

}  // extern "C"

#endif
