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
// One block a cell; its lane 0 runs the cell's serial recurrence, the
// warp's other lanes only move the cell's state in and out. The state —
// `tag`, `dirty`, `age` (sets x ways, int32) and the promotion filter's
// `shadow_tag`/`shadow_cnt` (sets) — lives in dynamic shared memory when
// every such cell of the launch fits the wrapper's budget (13,312 bytes at
// the default 128 x 8); a cell whose geometry does not fit works on its
// own state in device memory (the output buffer, filled from the input
// first), in the same kernel. Mode, promotion, flush scheduling, sets,
// ways and flush_per_op come from each cell's descriptor at run time, so
// every spec of a grid shares the launch. Per op the recurrence reads the
// set's W tags and ages (the lookup and the LRU victim in one pass), runs
// the promotion filter, updates the row, schedules flushes (per flush slot
// a set's W dirty flags and ages), and writes K sub-ops (arrival, lba,
// kind), the absorbed flag and, when asked, the host row: the eight
// cumulative counters and the dirty fraction. The next op's inputs are
// loaded while this op runs. The common way counts (2, 4, 8, 16) are
// template instances whose set scans unroll, and every load of a scan is
// unconditional (a load behind a branch cannot be issued before the branch
// is decided), so a scan's loads issue together instead of one dependent
// way at a time. The set index is a multiply-high by a magic number, not a
// division.
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
// `tier_cell` is plain C++ marked host and device: the same recurrence
// compiles for the CPU too (`host_tier_run_host`, built with a host C++
// compiler when no nvcc is present), which is how the tests check this
// file's arithmetic against the plain version on a machine without a
// card.

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

// One cell's whole trace through its host tier. `arrays` holds the cell's
// tag | dirty | age (sets x ways each), shadow_tag | shadow_cnt (sets):
// in shared memory or in device memory. `scal` the N_SCALARS scalars.
// WAYS > 0 fixes the way count at compile time, so every scan over a set
// unrolls and its loads issue together; WAYS = 0 reads it from the
// descriptor.
template <int WAYS>
HT_FN void tier_cell(const long long* d, const float* kn, int* arrays,
                     int* scal) {
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

  int tick = scal[0], dirty_n = scal[1], flushing = scal[2], fcur = scal[3];
  float prev_t = as_float(scal[4]);
  float hctr[N_HCTR];
  for (int i = 0; i < N_HCTR; ++i) hctr[i] = as_float(scal[5 + i]);

  float n_t = T > 0 ? arrival[0] : 0.0f;
  int n_lba = T > 0 ? lbas[0] : 0, n_kind = T > 0 ? kinds[0] : -1;
  for (long long i = 0; i < T; ++i) {
    const float t = n_t;
    const int lba = n_lba, kind = n_kind;
    if (i + 1 < T) {                   // the next op's inputs, early
      n_t = arrival[i + 1];
      n_lba = lbas[i + 1];
      n_kind = kinds[i + 1];
    }
    const bool live = kind >= 0;
    const bool is_write = kind == 1;
    const bool is_read = live && !is_write;

    // ---- lookup and the LRU victim, one pass over the set ----
    const int si = mod(lba, sets);
    int* trow = tag + si * W;
    int* drow = dirty + si * W;
    int* arow = age + si * W;
    bool hit = false;
    int way = 0, vic = 0, vmin = arow[0];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int tg = trow[w];          // loaded whatever the branches say
      const int a = arow[w];
      if (!hit && live && tg == lba) {
        hit = true;
        way = w;
      }
      if (a < vmin) {
        vmin = a;
        vic = w;
      }
    }
    tick += live ? 1 : 0;

    // ---- promotion filter ----
    bool promote_ok = live;
    if (nth) {
      const int sh = sh_cnt[si];
      const int cnt = sh_tag[si] == lba ? sh + 1 : 1;
      promote_ok = static_cast<float>(cnt) >= promote_n;
      if (live && !hit) {              // the filter sees misses only
        sh_tag[si] = lba;
        sh_cnt[si] = cnt;
      }
    }

    // ---- insert, victim, absorption ----
    const bool want = mode == MODE_WA ? (is_read && !hit) : (live && !hit);
    const bool ins = want && promote_ok;
    const int vic_tag = trow[vic];
    const int vic_dirty = drow[vic];
    const bool evict = ins && vic_dirty > 0 && vic_tag >= 0;
    const bool absorbed_w = mode == MODE_WB && is_write && (hit || ins);
    const bool absorbed_r = is_read && hit;
    const bool absorbed = absorbed_r || absorbed_w;

    // ---- the row: the hit way, or the inserted victim ----
    int d_delta = 0;
    if (hit) {
      arow[way] = tick;
      if (mode == MODE_WA && is_write) {   // superseded by the write
        trow[way] = -1;
        arow[way] = 0;
      }
      if (mode == MODE_WB && is_write) {
        if (drow[way] == 0) ++d_delta;
        drow[way] = 1;
      }
    }
    if (ins) {
      trow[vic] = lba;
      arow[vic] = tick;
      if (mode == MODE_WB) {
        drow[vic] = is_write ? 1 : 0;
        d_delta += (is_write ? 1 : 0) - (evict ? 1 : 0);
      } else {
        drow[vic] = 0;
      }
    }
    dirty_n += d_delta;

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
    float* st = sub_t + i * K;
    int* sl = sub_lba + i * K;
    int* sk = sub_kind + i * K;
    int n_flushed = 0;
    int fs = fcur;                     // the flush sets: fcur, fcur + 1, ...
    for (int f = 0; f < F; ++f, fs = fs + 1 == S ? 0 : fs + 1) {
      int* fd = dirty + fs * W;
      const int* fa = age + fs * W;
      bool has = false;
      int fw = 0, kmin = INT_BIG;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int dv = fd[w];          // both loaded whatever dv is
        const int av = fa[w];
        const bool dw = dv > 0;
        const int key = dw ? av : INT_BIG;
        has = has || dw;
        if (w == 0 || key < kmin) {
          kmin = key;
          fw = w;
        }
      }
      const bool do_flush = flush_on && has;
      const int ftag = tag[fs * W + fw];
      if (do_flush) {
        fd[fw] = 0;
        ++n_flushed;
      }
      st[2 + f] = t;
      sl[2 + f] = do_flush ? ftag : 0;
      sk[2 + f] = do_flush ? 1 : -1;
    }
    dirty_n -= n_flushed;
    if (flush_on) {                    // (fcur + F) mod S, F < S
      fcur += F;
      if (fcur >= S) fcur -= S;
    }

    // ---- slot 0 (the op, or a pad) and slot 1 (the write-back) ----
    st[0] = t;
    sl[0] = absorbed ? 0 : lba;
    sk[0] = absorbed ? -1 : kind;
    st[1] = t;
    sl[1] = evict ? vic_tag : 0;
    sk[1] = evict ? 1 : -1;
    absorbed_o[i] = absorbed ? 1 : 0;

    hctr[0] += hit ? 1.0f : 0.0f;
    hctr[1] += absorbed_r ? 1.0f : 0.0f;
    hctr[2] += (hit && is_write) ? 1.0f : 0.0f;
    hctr[3] += absorbed ? 1.0f : 0.0f;
    hctr[4] += absorbed_w ? 1.0f : 0.0f;
    hctr[5] += (live && !absorbed) ? 1.0f : 0.0f;
    hctr[6] += static_cast<float>(n_flushed);
    hctr[7] += evict ? 1.0f : 0.0f;
    if (live) prev_t = t;
    if (rows) {
      float* r = rows + i * N_ROW;
      for (int j = 0; j < N_HCTR; ++j) r[j] = hctr[j];
      r[N_HCTR] = static_cast<float>(dirty_n) * lines_inv;
    }
  }
  scal[0] = tick;
  scal[1] = dirty_n;
  scal[2] = flushing;
  scal[3] = fcur;
  scal[4] = as_int(prev_t);
  for (int i = 0; i < N_HCTR; ++i) scal[5 + i] = as_int(hctr[i]);
}

// a cell's recurrence, specialised to its way count where it is one of the
// common ones
HT_FN void run_tier(const long long* d, const float* kn, int* arrays,
                    int* scal) {
  switch (d[Q_WAYS]) {
    case 2: tier_cell<2>(d, kn, arrays, scal); break;
    case 4: tier_cell<4>(d, kn, arrays, scal); break;
    case 8: tier_cell<8>(d, kn, arrays, scal); break;
    case 16: tier_cell<16>(d, kn, arrays, scal); break;
    default: tier_cell<0>(d, kn, arrays, scal);
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

__global__ void __launch_bounds__(BLOCK_THREADS)
    host_tier_kernel(const long long* desc, const float* knobs,
                     const int* state_in, int* state_out) {
  extern __shared__ __align__(16) int smem[];
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
  if (threadIdx.x == 0) {
    if (d[Q_SMEM]) run_tier(d, kn, smem, out + n_arr);
    else run_tier(d, kn, out, out + n_arr);
  }
  __syncthreads();
  if (arrays != out)
    for (long long i = threadIdx.x; i < n_arr; i += blockDim.x)
      out[i] = arrays[i];
}

extern "C" {

// Launch on `stream`: C blocks, block b running descriptor row b.
// `desc` (C, N_DESC) int64 and `knobs` (rows, N_KNOB) f32 on the device,
// `desc_host` the same descriptors on the host (checked here);
// `state_in`/`state_out` the cells' state words; `smem_bytes` the dynamic
// shared memory of a block (the largest shared-memory cell's arrays).
// Returns 0, cudaGetLastError() of the launch, or a negative code for
// refused arguments.
int host_tier_launch(const long long* desc, const float* knobs,
                     const int* state_in, int* state_out, int n_cells,
                     int smem_bytes, const long long* desc_host,
                     unsigned long long stream) {
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
  cudaError_t err = cudaFuncSetAttribute(
      host_tier_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  host_tier_kernel<<<n_cells, BLOCK_THREADS, smem_bytes,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      desc, knobs, state_in, state_out);
  return (int)cudaGetLastError();
}

}  // extern "C"

#else

extern "C" {

// The same recurrence on the CPU, cell after cell, every pointer a host
// pointer: the kernel's arithmetic where no card is present.
int host_tier_run_host(const long long* desc, const float* knobs,
                       const int* state_in, int* state_out, int n_cells) {
  for (int c = 0; c < n_cells; ++c) {
    const long long* d = desc + (size_t)c * N_DESC;
    const int rc = check_desc(d);
    if (rc) return rc;
    const long long words = state_words(d[Q_SETS], d[Q_WAYS]);
    int* out = state_out + d[Q_STATE];
    memcpy(out, state_in + d[Q_STATE], (size_t)words * 4);
    run_tier(d, knobs + d[Q_KNOB_ROW] * N_KNOB, out,
             out + words - N_SCALARS);
  }
  return 0;
}

}  // extern "C"

#endif
