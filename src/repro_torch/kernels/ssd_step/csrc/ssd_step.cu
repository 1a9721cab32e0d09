// ssd_step.cu — the hybrid-SSD simulator's per-op recurrence for a whole
// sweep in one launch, written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_segment_stream_kernel` of the reference package
// (src/repro/kernels/ssd_step/kernel.py:46, launched by
// `run_segments_kernel`): one cell's (S, K) compressed-segment stream with
// the residency maps held in fast memory. This kernel runs C cells at once,
// one thread block per cell, and the cells of one launch may differ in
// everything but the device configuration: composition, mode, stream form
// (the per-op stream, K = 1, src = -1, scat_lba = lba — null pointers —
// or the K-lane segment stream with its hazard plan), length and pad tail.
// Each block reads its cell's descriptor and dispatches once, before the op
// loop, to `run_cell<COMP, CLOSED, ONE_LANE, WEAR, PROBE>` (8
// compositions x 2 modes x K = 1 or not, and the wear form: 16
// compositions x 2 modes at K = 1; each with the telemetry probe off and
// on). The wrapper orders the descriptors longest stream first,
// so a grid of more cells than SMs is scheduled longest-processing-time
// first. After the stream each cell replays its `n_pad` identical tail pads
// to their exact fixed point in-kernel, as the reference's
// `sim.replay_pads` does.
//
// What bounds it on this card: the longest cell's dependent op chain. Every
// op reads the plane state the previous op wrote, so a cell is one serial
// recurrence; the bytes are small (12 bytes of op stream and 4 of latency
// per op, plus 200 KB of carry in and out per cell). The cell's residency
// maps (`loc` int8, 64 KB, and `loc_ep` int16, 128 KB, over 2^16 pages) and
// its 128-plane carry (3.5 KB) live in dynamic shared memory, so every
// gather, scatter and plane update is a shared-memory access; one thread
// runs the recurrence. The design keeps everything else off the chain:
//  - a producer warp stages the op stream into a two-stage ring in the
//    spare shared memory (2 x 1,024 ops x 12 bytes), full/empty mbarriers
//    per stage. It computes all that does not depend on the carry: the
//    clamped gather index, `plane = lba % P` (a run-time modulo), the op
//    kind, the hazard source and the checked scatter target, packed in
//    three words an op;
//  - the recurrence thread prefetches the next op's record while the core
//    runs, so no device-memory load and no modulo is on the chain;
//  - K = 1 has its own specialisation without lane buffers; K > 1 keeps
//    its four lane buffers in shared memory, not in local memory;
//  - latencies are stored to device memory and never waited on.
// Each block writes %globaltimer at its start and end, and the recurrence
// thread its op counts and clock64 cycles (total, and waiting on the
// ring) into an optional (C, 6) int64 timer output.
//
// The probe form (a cell whose descriptor sets window_ops > 0): the
// reference's telemetry probe (`telemetry/probe.py`, the `SimState.timeline`
// carry that rides its scan) as outputs of the recurrence thread,
// observation only, in every form of the kernel. Per scanned op it stores
// two head columns beside the latency: occ_pages, the running float32 sum
// of the op's change in resident pages (slc + trad, on its plane), and
// max(idle_claim, 0); the wrapper's window assembly divides occ_pages by
// the cell's capacity (the reference's occupancy fraction, an IEEE
// division either way), so the stepping thread pays an add and a store
// an op. At every window boundary op min((w+1)*wo - 1, t_len - 1) it
// stores the ten counters, in the pad tail too (once the tail reaches its
// fixed point every later boundary gets the final counters, as the
// reference's `replay_pads_windowed`); in the wear form also the plane's
// peak effective cycles at each boundary. Its state is a register and a
// boundary index, no shared memory; its stores go to device memory and are
// never waited on. The probe is a template parameter (PROBE), chosen once
// a cell from its descriptor: with the probe off a cell runs the code it
// ran before the probe existed (a run-time predicate in that code cost 11%
// of the paper grid's launch on an H100 80GB HBM3 at 700 W, 345 -> 384
// cycles an op).
//
// The wear form (a cell whose descriptor names a wear row). The reference
// tracks endurance per op only, so the wear form is the K = 1 path. Its
// per-plane wear rows — pe_slc and pe_rp (P, 8), pe_tlc, erase, pe_trad and
// erase_trad (P,), 10,240 bytes at 128 planes — live in shared memory: a
// wear cell's op ring has stages of 512 ops, not 1,024, and the rows take
// the ring space this frees, so a wear cell's block needs no more shared
// memory than any other. The ops seen and the end-of-life op ride in
// registers. On the chain this adds the plane row's loads and stores, the
// reliability gate (gated compositions), the retention read penalty (reads,
// when read_penalty_ms != 0), the bucket placement, and the end-of-life
// check until the cell's end of life is found: its max over the 8 bucket
// cycles is taken over the weighted sums before the one division by the
// bucket's page share and the erase term (both monotone, so the max is the
// same), and the check stops once eol_op is set (it could not change it).
//
// Bit identity with the reference. The reference's compiler (XLA on the
// CPU) fuses exactly four of the core's multiply-adds into FMA
// instructions: `budget - mig * c_mig` (migrate, and the gated fallback),
// `budget - ops1 * c_trad_rp` and `budget - ops2 * c_mig` (dual reclaim)
// and `agc_waste + ops * waste_p` (AGC). Those four are written as
// __fmaf_rn here, and the file is built with -fmad=false so that nvcc fuses
// nothing else: `used_ms + erase_total` (migrate) rounds `mig * c_mig`
// first, as there. A quotient by one of the core's constants, `budget /
// c_mig`, XLA's algebraic simplifier turns into `budget * float32(1 /
// c_mig)`: it is that product here (`trunc_mul`), truncated to int32 as the
// reference's astype does. The wear form's sites follow the reference's
// compiled core the same way (`endurance/model.py` of the port lists
// them); a quotient by a per-cell value is an IEEE division (no fast
// math). The composition's constants arrive from the wrapper already
// rounded once from Python doubles to float32, the rounding the
// reference's weak-typed Python floats get. Packed int16 plane fields are widened to int32 by the
// wrapper; every residency comparison goes through explicit int16/int8
// casts, so the widened carry is value-exact for both layouts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum {
  CTR_HOST_W = 0, CTR_SLC_W, CTR_TLC_W, CTR_RP_HOST, CTR_RP_AGC, CTR_RP_TRAD,
  CTR_MIG_W, CTR_ERASES, CTR_AGC_WASTE, CTR_CONFLICT_MS, N_CTR
};

constexpr int WATERMARK_NUM = 7;
constexpr int WATERMARK_DEN = 8;
constexpr int MAX_LANES = 32;
constexpr int MAX_PAGES = 1 << 16;   // the ring's 16-bit page index
constexpr int BLOCK_THREADS = 256;
constexpr int PRODUCER_WARP = 1;
constexpr int STAGE_OPS = 1024;      // ops a ring stage holds
constexpr int WEAR_STAGE_OPS = 512;  // ... in a wear cell's block
constexpr int N_STAGES = 2;
constexpr int WEAR_B = 8;            // wear buckets a plane's row holds
constexpr int REC_WORDS = 3;         // arrival; gather|plane|kind; scat|src
constexpr uint32_t KEEP = 0x10000u;  // the scatter target is in range

// composition bits (the wrapper's `composition_code`)
constexpr int DUAL = 1, ADAPTIVE = 2, MIGRATE = 4, PRESSURE = 8, AGC = 16,
              GATED = 32, WEAR_MIN = 64;

// float constants, in the order of the wrapper's `kernel_constants`
enum {
  K_C_MIG = 0, K_C_AGC, K_C_TRAD_RP, K_OVERRUN_MS, K_AGC_HALF, K_ERASE_MS,
  K_SLC_READ, K_TLC_READ, K_SLC_WRITE, K_TLC_WRITE, K_REPROGRAM,
  K_INV_C_MIG, K_INV_C_AGC, K_INV_C_TRAD_RP, K_INV_BUCKETS, N_FCONST
};

// a wear row's endurance knobs, in the order of `EnduranceParams`
enum {
  E_W_SLC = 0, E_W_TLC, E_W_RP, E_W_ERASE, E_CYCLE_BUDGET, E_RP_BUDGET,
  E_READ_PENALTY, E_RP_HYSTERESIS, N_ENDUR
};

// a cell's descriptor: int64 fields, in the order of the wrapper's
// `_DESC_ORDER` (pointers to the cell's own (S, K) op stream and latency)
enum {
  Q_ARRIVAL = 0, Q_LBA, Q_IS_WRITE, Q_SRC, Q_SCAT, Q_LAT_O, Q_COMP,
  Q_CLOSED, Q_S, Q_K, Q_N_PAD, Q_ROW, Q_WEAR,
  // the probe: ops a window (0: off), head (n_ops, 2) f32, counter
  // snapshots (W, N_CTR) f32, wear peaks (W,) f32 (wear cells only)
  Q_WO, Q_HEAD, Q_SNAP, Q_PEAK, N_DESC
};

// pointer table, in the order of the wrapper's `_PTR_ORDER`; every
// per-cell array is indexed by the descriptor's row
enum {
  P_DESC = 0, P_CAP_BASIC, P_CAP_TRAD, P_CAP_BOOST, P_IDLE_THR, P_WASTE_P,
  P_PAD_T, P_BUSY, P_SLC, P_RP, P_TRAD, P_VM, P_EP, P_CTR, P_PREV_T,
  P_IDLE_CUM, P_IDLE_SEEN, P_LOC, P_LOC_EP,
  P_BUSY_O, P_SLC_O, P_RP_O, P_TRAD_O, P_VM_O, P_EP_O, P_CTR_O,
  P_PREV_T_O, P_IDLE_CUM_O, P_IDLE_SEEN_O, P_LOC_O, P_LOC_EP_O, P_TIMER,
  P_ENDUR, P_WEAR, P_WEAR_O, N_PTR
};

// integer dims, in the order of the wrapper's `_DIM_ORDER`
enum { D_C = 0, D_P, D_N, D_PPB, N_DIM };

// the timer output's columns (the wrapper's `TIMER_COLUMNS`)
enum {
  T_START = 0, T_END, T_SCANNED, T_PADS, T_CYCLES, T_WAIT, N_TIMER
};

// The launch's pages per SLC block as a divisor that needs no integer
// division on the chain (the card has none; its emulation is some tens of
// dependent instructions): for n >= 0, n / d by a multiply-high and two
// shifts (Granlund and Montgomery), exact for every 32-bit n.
struct Divisor {
  int d;           // >= 1
  uint32_t m;      // magic multiplier (d > 1)
  int l;           // ceil(log2(d))
};

Divisor make_divisor(int d) {
  Divisor v;
  v.d = d;
  v.l = 0;
  while ((1LL << v.l) < d) ++v.l;
  v.m = d > 1 ? static_cast<uint32_t>(
                    ((1ULL << 32) * ((1ULL << v.l) - (unsigned long long)d)) /
                        (unsigned long long)d + 1)
              : 0u;
  return v;
}

struct Args {
  const long long* desc;
  const int* cap_basic; const int* cap_trad; const int* cap_boost;
  const float* idle_thr; const float* waste_p; const float* pad_t;
  const float* busy; const int* slc; const int* rp; const int* trad;
  const int* vm; const int* ep; const float* ctr; const float* prev_t;
  const float* idle_cum; const float* idle_seen;
  const int8_t* loc; const int16_t* loc_ep;
  float* busy_o; int* slc_o; int* rp_o; int* trad_o;
  int* vm_o; int* ep_o; float* ctr_o; float* prev_t_o; float* idle_cum_o;
  float* idle_seen_o; int8_t* loc_o; int16_t* loc_ep_o;
  long long* timer;                              // null: not timed
  const float* endur;                            // (wear rows, N_ENDUR)
  const float* wear; float* wear_o;              // (wear rows, wear_words)
  int C, P, N;
  Divisor ppb;
  float k[N_FCONST];
};

// One cell's carry while its thread runs the recurrence: plane arrays in
// shared memory, the counters and the two idle scalars in registers; for a
// wear cell its wear rows in shared memory and two scalars in registers.
struct Carry {
  float* busy; int* slc; int* rp; int* trad; int* vm; int* ep;
  float* idle_seen;
  float ctr[N_CTR];
  float prev_t, idle_cum;
  float* pe_slc; float* pe_rp; float* pe_tlc; float* erase;
  float* pe_trad; float* erase_trad;
  float ops_seen, eol_op;
  float occ_pages;            // the probe's running resident pages
};

struct Knobs {
  int cap_basic, cap_trad, cap_boost;
  float idle_thr, waste_p;
  // the wear form's knobs and their per-cell derived values
  float w_slc, w_rp, w_erase, cycle_budget, budget_floor, rp_budget, rp_lo,
      read_penalty, cap_f, cap_t_f, per_bucket;
};

template <int COMP>
__device__ __forceinline__ int eff_cap(int slc_used, const Knobs& kn) {
  if (COMP & ADAPTIVE) {
    const bool above = slc_used >= (WATERMARK_NUM * kn.cap_basic) / WATERMARK_DEN;
    return above ? kn.cap_basic + kn.cap_boost : kn.cap_basic;
  }
  return kn.cap_basic;
}

__device__ __forceinline__ int ceil_div(int a, const Divisor& v) {
  const int n = a + v.d - 1;
  if (n < 0) return n / v.d;             // never for a valid carry
  if (v.d == 1) return n;
  const uint32_t un = static_cast<uint32_t>(n);
  const uint32_t t = __umulhi(v.m, un);
  return static_cast<int>((t + ((un - t) >> 1)) >> (v.l - 1));
}

// (int)(a * r), r = float32(1 / c): the reference's `(a / c).astype(int32)`
// for a constant c as its compiler computes it (a product with the
// reciprocal), truncated as its astype truncates.
__device__ __forceinline__ int trunc_mul(float a, float r) {
  return static_cast<int>(a * r);
}

// A wear cell's packed state (`_WEAR_ORDER` of the wrapper), floats:
// pe_slc (P, 8), pe_rp (P, 8), pe_tlc, erase, pe_trad, erase_trad (P,),
// ops_seen, eol_op.
__host__ __device__ constexpr long long wear_words(int P) {
  return 2LL * P * WEAR_B + 4LL * P + 2;
}

// min(n * WEAR_B / d, WEAR_B - 1) for n >= 0, d >= 1: the bucket of a fill
// position, by comparisons (no integer division on the chain)
__device__ __forceinline__ int bucket_of(int n, int d) {
  const int scaled = n * WEAR_B;
  int b = 0;
#pragma unroll
  for (int j = 1; j < WEAR_B; ++j) b += (scaled >= j * d) ? 1 : 0;
  return b;
}

// a row's float32 sum, left to right (the reference's compiled order)
__device__ __forceinline__ float row_sum(const float (&r)[WEAR_B]) {
  float s = r[0];
#pragma unroll
  for (int j = 1; j < WEAR_B; ++j) s = s + r[j];
  return s;
}

// The per-op core (the reference engine's `_build_core`), in its fragment
// order. Reads the plane state, computes, then writes it back; returns
// whether any carry value changed (the fixed-point test of the tail replay;
// wear cells replay no tail). `plane` is the op's `lba % P`, computed off
// the chain by the producer. With PROBE it also hands out the probe's
// observations (`Obs`): the op's change in resident pages on its plane,
// the idle budget it claimed, and (wear form, when `want_peak`) the
// plane's peak effective cycles.
struct Obs {
  int occ_delta;
  float idle_claim;
  bool want_peak;
  float peak;
};

template <int COMP, bool CLOSED, bool WEAR, bool PROBE>
__device__ __forceinline__ bool core(
    Carry& c, const Knobs& kn, const float* __restrict__ k, int P,
    const Divisor& ppb,
    float t, int plane, int kind, int old_raw, int old_ep,
    float& latency_out, int& loc_val_out, int& loc_ep_val_out, Obs& obs) {
  constexpr bool dual = COMP & DUAL;
  constexpr bool run_migrate = COMP & MIGRATE;
  constexpr bool gated = COMP & GATED;
  constexpr bool use_rp = !run_migrate;
  constexpr bool pressure = COMP & PRESSURE;
  constexpr bool run_agc = COMP & AGC;
  constexpr bool run_dual_reclaim = dual && run_agc;
  constexpr bool wear_aware = COMP & WEAR_MIN;
  static_assert(WEAR || !(COMP & (GATED | WEAR_MIN)),
                "the gate and wear-aware placement read the wear rows");

  const bool is_pad = kind < 0;
  const bool is_write = kind == 1;
  const float busy_p = c.busy[plane];
  float ctr[N_CTR];
#pragma unroll
  for (int i = 0; i < N_CTR; ++i) ctr[i] = c.ctr[i];
  const int slc0 = c.slc[plane], rp0 = c.rp[plane], trad0 = c.trad[plane];
  const int ep0 = c.ep[plane];
  int slc_used = slc0, rp_done = rp0, trad_used = trad0;
  int valid_mig = c.vm[plane], epoch_p = ep0;
  float conflict = 0.0f;

  // the plane's wear row (registers while the op runs)
  float ws[WEAR_B], wr[WEAR_B];
  float pe_tlc_p = 0.0f, erase_p = 0.0f, pe_trad_p = 0.0f, erase_trad_p = 0.0f;
  bool gate_ok = true, fallback_on = false;
  if (WEAR) {
    const float4* s4 = reinterpret_cast<const float4*>(c.pe_slc + plane * WEAR_B);
    const float4* r4 = reinterpret_cast<const float4*>(c.pe_rp + plane * WEAR_B);
#pragma unroll
    for (int j = 0; j < WEAR_B / 4; ++j) {
      const float4 a = s4[j], b = r4[j];
      ws[4 * j] = a.x; ws[4 * j + 1] = a.y; ws[4 * j + 2] = a.z; ws[4 * j + 3] = a.w;
      wr[4 * j] = b.x; wr[4 * j + 1] = b.y; wr[4 * j + 2] = b.z; wr[4 * j + 3] = b.w;
    }
    pe_tlc_p = c.pe_tlc[plane];
    erase_p = c.erase[plane];
    pe_trad_p = c.pe_trad[plane];
    erase_trad_p = c.erase_trad[plane];
    if (gated) {
      // RARO-style reliability gate: the plane's per-page reprogram count
      // against the budget, with the hysteresis band pre-arming the fallback
      const float rp_count = row_sum(wr) / kn.cap_f;
      gate_ok = rp_count < kn.rp_budget;
      fallback_on = rp_count >= kn.rp_lo;
    }
  }

  // 1. idle work on this plane, lazily applied for [busy_p, t)
  float idle_cum = c.idle_cum;
  const float idle_seen_p = c.idle_seen[plane];
  if (!CLOSED) {
    const float gap = fmaxf(t - c.prev_t, 0.0f);
    idle_cum = idle_cum + ((gap > kn.idle_thr && !is_pad) ? gap : 0.0f);
    const float dev_budget = is_pad ? 0.0f : idle_cum - idle_seen_p;
    const float full_gap = is_pad ? 0.0f : fmaxf(t - busy_p, 0.0f);

    if (run_migrate) {
      const int eff = eff_cap<COMP>(slc_used, kn);
      bool above_wm = false;
      float budget = dev_budget;
      if (pressure) {
        above_wm = slc_used >= (WATERMARK_NUM * eff) / WATERMARK_DEN;
        const float overrun_allow = slc_used < eff ? k[K_OVERRUN_MS] : 0.0f;
        budget = above_wm ? full_gap + overrun_allow : dev_budget;
      }
      const int mig = min(valid_mig, trunc_mul(budget, k[K_INV_C_MIG]));
      valid_mig = valid_mig - mig;
      float used_ms = (float)mig * k[K_C_MIG];
      budget = __fmaf_rn(-(float)mig, k[K_C_MIG], budget);  // fused there
      ctr[CTR_MIG_W] = ctr[CTR_MIG_W] + (float)mig;
      const int blocks = ceil_div(slc_used, ppb);
      const float erase_total = (float)blocks * k[K_ERASE_MS];
      const bool can_erase = valid_mig == 0 && slc_used > 0 && budget >= erase_total;
      ctr[CTR_ERASES] = ctr[CTR_ERASES] + (float)(can_erase ? blocks : 0);
      if (WEAR) {
        // migrations program TLC pages; the erase cycles the region blocks
        pe_tlc_p = pe_tlc_p + (float)mig;
        erase_p = erase_p + (can_erase ? 1.0f : 0.0f);
      }
      epoch_p = epoch_p + (can_erase ? 1 : 0);
      slc_used = can_erase ? 0 : slc_used;
      used_ms = used_ms + (can_erase ? erase_total : 0.0f);
      if (pressure) {
        // overrun beyond the real gap stalls the arriving write
        conflict = conflict + ((above_wm && is_write)
                               ? fmaxf(used_ms - full_gap, 0.0f) : 0.0f);
      }
    }
    if (gated) {
      // past the gate's warning band the region is also reclaimed like a
      // traditional cache, on device-idle budget only
      float budget = fallback_on ? dev_budget : 0.0f;
      const int mig = min(valid_mig, trunc_mul(budget, k[K_INV_C_MIG]));
      valid_mig = valid_mig - mig;
      budget = __fmaf_rn(-(float)mig, k[K_C_MIG], budget);  // fused there
      ctr[CTR_MIG_W] = ctr[CTR_MIG_W] + (float)mig;
      const int blocks = ceil_div(slc_used, ppb);
      // erase only a watermark-full region
      const bool full_enough =
          slc_used >= (WATERMARK_NUM * kn.cap_basic) / WATERMARK_DEN;
      const bool can_erase = valid_mig == 0 && full_enough &&
                             budget >= (float)blocks * k[K_ERASE_MS];
      ctr[CTR_ERASES] = ctr[CTR_ERASES] + (float)(can_erase ? blocks : 0);
      pe_tlc_p = pe_tlc_p + (float)mig;
      erase_p = erase_p + (can_erase ? 1.0f : 0.0f);
      epoch_p = epoch_p + (can_erase ? 1 : 0);
      slc_used = can_erase ? 0 : slc_used;
      rp_done = can_erase ? 0 : rp_done;
    }
    if (run_dual_reclaim) {
      float budget = dev_budget;
      int rp_avail = 2 * slc_used - rp_done;
      const int ops1 = min(min(valid_mig, rp_avail),
                           trunc_mul(budget, k[K_INV_C_TRAD_RP]));
      rp_done = rp_done + ops1;
      valid_mig = valid_mig - ops1;
      budget = __fmaf_rn(-(float)ops1, k[K_C_TRAD_RP], budget);
      ctr[CTR_RP_TRAD] = ctr[CTR_RP_TRAD] + (float)ops1;
      if (WEAR) {
        // batched reprogram fills spread page-granularly over the region
        const float add = (float)ops1 * k[K_INV_BUCKETS];
#pragma unroll
        for (int j = 0; j < WEAR_B; ++j) wr[j] = wr[j] + add;
      }
      rp_avail = 2 * slc_used - rp_done;
      const int ops2 = min(rp_avail == 0 ? valid_mig : 0,
                           trunc_mul(budget, k[K_INV_C_MIG]));
      valid_mig = valid_mig - ops2;
      budget = __fmaf_rn(-(float)ops2, k[K_C_MIG], budget);
      ctr[CTR_MIG_W] = ctr[CTR_MIG_W] + (float)ops2;
      if (WEAR) pe_tlc_p = pe_tlc_p + (float)ops2;
      const int blocks = ceil_div(trad_used, ppb);
      const bool can_erase = valid_mig == 0 && trad_used > 0 &&
                             budget >= (float)blocks * k[K_ERASE_MS];
      ctr[CTR_ERASES] = ctr[CTR_ERASES] + (float)(can_erase ? blocks : 0);
      if (WEAR) erase_trad_p = erase_trad_p + (can_erase ? 1.0f : 0.0f);
      epoch_p = epoch_p + (can_erase ? 1 : 0);
      trad_used = can_erase ? 0 : trad_used;
    }
    if (run_agc) {
      int rp_avail = 2 * slc_used - rp_done;
      if (dual) rp_avail = valid_mig == 0 ? rp_avail : 0;
      if (gated) rp_avail = gate_ok ? rp_avail : 0;
      const int ops = min(rp_avail, trunc_mul(full_gap, k[K_INV_C_AGC]));
      rp_done = rp_done + ops;
      const float opsf = (float)ops;
      ctr[CTR_RP_AGC] = ctr[CTR_RP_AGC] + opsf;
      ctr[CTR_AGC_WASTE] = __fmaf_rn(opsf, kn.waste_p, ctr[CTR_AGC_WASTE]);
      if (WEAR) {
        // page-granular fills spread evenly over the region's buckets
        const float add = opsf * k[K_INV_BUCKETS];
#pragma unroll
        for (int j = 0; j < WEAR_B; ++j) wr[j] = wr[j] + add;
      }
      const bool agc_active = (2 * slc_used - rp_done) > 0;
      conflict = conflict + ((agc_active && is_write) ? k[K_AGC_HALF] : 0.0f);
    }
  }

  // the probe's idle claim: the device idle this op's plane consumed
  if (PROBE) obs.idle_claim = is_pad ? 0.0f : idle_cum - idle_seen_p;

  // generation completion: fully reprogrammed region -> fresh layer
  if (use_rp) {
    const bool fresh = slc_used > 0 && rp_done >= 2 * slc_used;
    slc_used = fresh ? 0 : slc_used;
    rp_done = fresh ? 0 : rp_done;
  }

  // 2. service the op
  float wait, start;
  if (CLOSED) {
    wait = 0.0f;
    start = busy_p + conflict;
  } else {
    wait = fmaxf(busy_p - t, 0.0f);
    start = t + wait + conflict;
  }
  const int old = old_raw;
  const int old_clip = min(max(old, 0), P - 1);
  // epoch may have been bumped this step (erase) for the local plane
  const int epoch_eff = old_clip == plane ? epoch_p : c.ep[old_clip];
  const bool old_ok = old >= 0 && (int16_t)old_ep == (int16_t)epoch_eff;

  const bool to_slc = is_write && slc_used < eff_cap<COMP>(slc_used, kn);
  const bool to_trad = dual && is_write && !to_slc && trad_used < kn.cap_trad;
  const bool to_rp = use_rp && is_write && !to_slc && !to_trad &&
                     (2 * slc_used - rp_done) > 0 && gate_ok;
  const bool to_tlc = is_write && !to_slc && !to_trad && !to_rp;

  const float prog_t = (to_slc || to_trad) ? k[K_SLC_WRITE]
                       : (to_rp ? k[K_REPROGRAM] : k[K_TLC_WRITE]);
  // gated regions keep ips's conservative read model: hits read at TLC speed
  float read_t = old_ok ? (gated ? k[K_TLC_READ] : k[K_SLC_READ]) : k[K_TLC_READ];
  if (WEAR && !is_write && !is_pad && kn.read_penalty != 0.0f) {
    // retention read cost (only a read's service reads it; a zero penalty
    // adds an exact zero)
    const float s_slc = row_sum(ws), s_rp = row_sum(wr);
    const float a = dual ? __fmaf_rn(kn.w_rp, s_rp, kn.w_slc * s_slc)
                         : __fmaf_rn(kn.w_slc, s_slc, kn.w_rp * s_rp);
    const float plane_cyc = __fmaf_rn(kn.w_erase, erase_p, a / kn.cap_f);
    const float trad_cyc =
        __fmaf_rn(kn.w_erase, erase_trad_p, kn.w_slc * pe_trad_p / kn.cap_t_f);
    const float aged = fmaxf(plane_cyc, trad_cyc);
    const float age = fminf(fmaxf(aged / kn.budget_floor, 0.0f), 1.0f);
    read_t = __fmaf_rn(kn.read_penalty, age, read_t);
  }
  float service = is_write ? prog_t : read_t;
  service = is_pad ? 0.0f : service;
  const float latency = is_pad ? 0.0f : wait + conflict + service;
  const float busy_new = is_pad ? busy_p : start + service;

  // wear placement (before the bookkeeping moves slc_used / rp_done): a
  // basic-region program lands in its fill position's bucket, or the
  // coldest under wear-aware allocation; reprogram stress at the
  // conversion position
  if (WEAR) {
    if (to_slc) {
      int b = 0;
      if (wear_aware) {
        float best = __fmaf_rn(kn.w_slc, ws[0], kn.w_rp * wr[0]);
#pragma unroll
        for (int j = 1; j < WEAR_B; ++j) {
          const float v = __fmaf_rn(kn.w_slc, ws[j], kn.w_rp * wr[j]);
          if (v < best) { best = v; b = j; }
        }
      } else {
        b = bucket_of(slc_used, max(kn.cap_basic, 1));
      }
#pragma unroll
      for (int j = 0; j < WEAR_B; ++j) ws[j] = (j == b) ? ws[j] + 1.0f : ws[j];
    }
    if (to_rp) {
      const int b = bucket_of(rp_done, max(2 * slc_used, 1));
#pragma unroll
      for (int j = 0; j < WEAR_B; ++j) wr[j] = (j == b) ? wr[j] + 1.0f : wr[j];
    }
    pe_tlc_p = pe_tlc_p + (to_tlc ? 1.0f : 0.0f);
    pe_trad_p = pe_trad_p + (to_trad ? 1.0f : 0.0f);
    const float ops_seen = c.ops_seen + (is_pad ? 0.0f : 1.0f);
    const bool eol_live = c.eol_op < 0.0f && !is_pad;
    if (eol_live || (PROBE && obs.want_peak)) {
      // the worst block's effective cycles: against the budget until the
      // end of life is found, and the probe's peak at a window boundary
      float vmax = __fmaf_rn(kn.w_slc, ws[0], kn.w_rp * wr[0]);
#pragma unroll
      for (int j = 1; j < WEAR_B; ++j)
        vmax = fmaxf(vmax, __fmaf_rn(kn.w_slc, ws[j], kn.w_rp * wr[j]));
      const float erase_term = kn.w_erase * erase_p;
      const float bucket_max = vmax / kn.per_bucket + erase_term;
      const float trad_cyc =
          __fmaf_rn(kn.w_erase, erase_trad_p, kn.w_slc * pe_trad_p / kn.cap_t_f);
      const float peak = fmaxf(bucket_max, trad_cyc);
      if (eol_live && peak >= kn.cycle_budget) c.eol_op = ops_seen;
      if (PROBE) obs.peak = peak;
    }
    c.ops_seen = ops_seen;
    float4* s4 = reinterpret_cast<float4*>(c.pe_slc + plane * WEAR_B);
    float4* r4 = reinterpret_cast<float4*>(c.pe_rp + plane * WEAR_B);
#pragma unroll
    for (int j = 0; j < WEAR_B / 4; ++j) {
      s4[j] = make_float4(ws[4 * j], ws[4 * j + 1], ws[4 * j + 2], ws[4 * j + 3]);
      r4[j] = make_float4(wr[4 * j], wr[4 * j + 1], wr[4 * j + 2], wr[4 * j + 3]);
    }
    c.pe_tlc[plane] = pe_tlc_p;
    c.erase[plane] = erase_p;
    c.pe_trad[plane] = pe_trad_p;
    c.erase_trad[plane] = erase_trad_p;
  }

  // bookkeeping
  slc_used = slc_used + (to_slc ? 1 : 0);
  trad_used = trad_used + (to_trad ? 1 : 0);
  rp_done = rp_done + (to_rp ? 1 : 0);
  // residency tracking covers exactly the migratable region
  const bool track_new =
      (run_migrate || gated) ? (to_slc || to_rp) : (dual ? to_trad : false);
  const int valid_dec = (is_write && old_ok) ? 1 : 0;
  if (PROBE) obs.occ_delta = (slc_used + trad_used) - (slc0 + trad0);

  ctr[CTR_HOST_W] = ctr[CTR_HOST_W] + (is_write ? 1.0f : 0.0f);
  ctr[CTR_SLC_W] = ctr[CTR_SLC_W] + ((to_slc || to_trad) ? 1.0f : 0.0f);
  ctr[CTR_TLC_W] = ctr[CTR_TLC_W] + (to_tlc ? 1.0f : 0.0f);
  ctr[CTR_RP_HOST] = ctr[CTR_RP_HOST] + (to_rp ? 1.0f : 0.0f);
  ctr[CTR_CONFLICT_MS] = ctr[CTR_CONFLICT_MS] + (is_write ? conflict : 0.0f);

  // mapping update: writes set the new location; reads/pads keep it
  loc_val_out = (int8_t)(is_write ? (track_new ? plane : -1) : old);
  loc_ep_val_out = (int16_t)((is_write && track_new) ? epoch_p : old_ep);
  latency_out = latency;

  // write the carry back, noting whether any value changed
  const int vm_plane0 = c.vm[plane], vm_clip0 = c.vm[old_clip];
  const float seen_new = is_pad ? idle_seen_p : idle_cum;
  const float prev_t_new = is_pad ? c.prev_t : t;
  bool changed = busy_new != busy_p || slc_used != slc0 || rp_done != rp0 ||
                 trad_used != trad0 || epoch_p != ep0 ||
                 seen_new != idle_seen_p || prev_t_new != c.prev_t ||
                 idle_cum != c.idle_cum;
  c.busy[plane] = busy_new;
  c.slc[plane] = slc_used;
  c.rp[plane] = rp_done;
  c.trad[plane] = trad_used;
  c.vm[plane] = valid_mig;
  c.vm[old_clip] -= valid_dec;
  c.vm[plane] += track_new ? 1 : 0;
  changed = changed || c.vm[plane] != vm_plane0 || c.vm[old_clip] != vm_clip0;
  c.ep[plane] = epoch_p;
  c.idle_seen[plane] = seen_new;
  c.prev_t = prev_t_new;
  c.idle_cum = idle_cum;
#pragma unroll
  for (int i = 0; i < N_CTR; ++i) {
    changed = changed || ctr[i] != c.ctr[i];
    c.ctr[i] = ctr[i];
  }
  return changed;
}

// ---------------------------------------------------------------------------
// shared memory and the ring's barriers
// ---------------------------------------------------------------------------

__host__ __device__ constexpr long long carry_bytes(int P, int N) {
  return 7LL * 4 * P + 3LL * N;          // seven (P,) arrays, loc_ep, loc
}

__host__ __device__ constexpr long long align16(long long b) {
  return (b + 15) & ~15LL;
}

constexpr int LANE_BYTES = 4 * 4 * MAX_LANES;      // old, ep, buf_loc, buf_ep
constexpr int BAR_BYTES = 8 * 2 * N_STAGES;        // full and empty
constexpr int RING_BYTES = N_STAGES * STAGE_OPS * REC_WORDS * 4;

__host__ __device__ constexpr long long block_bytes(int P, int N) {
  return align16(carry_bytes(P, N)) + LANE_BYTES + BAR_BYTES + RING_BYTES;
}

struct Smem {
  float* busy; int* slc; int* rp; int* trad; int* vm; int* ep;
  float* idle_seen; int16_t* loc_ep; int8_t* loc;
  int* lane;                 // old_k, ep_k, buf_loc, buf_ep: MAX_LANES each
  uint64_t* full;            // N_STAGES, then empty: N_STAGES
  uint64_t* empty;
  uint32_t* ring;            // N_STAGES x STAGE_OPS x REC_WORDS
};

__device__ __forceinline__ Smem carve(unsigned char* smem, int P, int N) {
  Smem s;
  s.busy = reinterpret_cast<float*>(smem);
  s.slc = reinterpret_cast<int*>(s.busy + P);
  s.rp = s.slc + P;
  s.trad = s.rp + P;
  s.vm = s.trad + P;
  s.ep = s.vm + P;
  s.idle_seen = reinterpret_cast<float*>(s.ep + P);
  s.loc_ep = reinterpret_cast<int16_t*>(s.idle_seen + P);
  s.loc = reinterpret_cast<int8_t*>(s.loc_ep + N);
  unsigned char* tail = smem + align16(carry_bytes(P, N));
  s.lane = reinterpret_cast<int*>(tail);
  s.full = reinterpret_cast<uint64_t*>(tail + LANE_BYTES);
  s.empty = s.full + N_STAGES;
  s.ring = reinterpret_cast<uint32_t*>(tail + LANE_BYTES + BAR_BYTES);
  return s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// ring ops a stage holds: a wear cell's stages are half as long (its wear
// rows take the other half of the ring's space)
__device__ __forceinline__ int stage_cap_of(bool wear) {
  return wear ? WEAR_STAGE_OPS : STAGE_OPS;
}

// ops of whole segments a stage holds
__device__ __forceinline__ int stage_ops_of(int K, bool wear) {
  return (stage_cap_of(wear) / K) * K;
}

// ---------------------------------------------------------------------------
// the producer warp: the cell's op stream into the ring
// ---------------------------------------------------------------------------

__device__ __forceinline__ void produce(const long long* d, const Smem& s,
                                        int P, int N) {
  const int lane = threadIdx.x & 31;
  const float* arrival = reinterpret_cast<const float*>(d[Q_ARRIVAL]);
  const int* lba = reinterpret_cast<const int*>(d[Q_LBA]);
  const int* is_write = reinterpret_cast<const int*>(d[Q_IS_WRITE]);
  const int* src = reinterpret_cast<const int*>(d[Q_SRC]);
  const int* scat = reinterpret_cast<const int*>(d[Q_SCAT]);
  const int K = static_cast<int>(d[Q_K]);
  const bool wear = d[Q_WEAR] >= 0;
  const long long n_ops = d[Q_S] * K;
  const int per_stage = stage_ops_of(K, wear);
  const int stride = stage_cap_of(wear) * REC_WORDS;
  int st = 0;
  for (long long base = 0; base < n_ops; base += per_stage, ++st) {
    const int slot = st % N_STAGES;
    if (st >= N_STAGES) mbar_wait(s.empty + slot, ((st / N_STAGES) - 1) & 1);
    const int cnt = static_cast<int>(min(static_cast<long long>(per_stage),
                                         n_ops - base));
    uint32_t* rec = s.ring + slot * stride;
    for (int i = lane; i < cnt; i += 32) {
      const long long o = base + i;
      const int l = __ldg(lba + o);
      const int kind = __ldg(is_write + o);
      const int sv = src ? __ldg(src + o) : -1;
      const int dst = scat ? __ldg(scat + o) : l;
      const int gather = min(max(l, 0), N - 1);
      const int plane = l % P;
      // the core reads only kind < 0 and kind == 1; src only src >= 0 and
      // its clamp to K - 1
      const int kind3 = kind < 0 ? -1 : (kind == 1 ? 1 : 0);
      const int src_c = sv < 0 ? -1 : min(sv, K - 1);
      const bool keep = dst >= 0 && dst < N;
      rec[REC_WORDS * i] = __float_as_uint(__ldg(arrival + o));
      rec[REC_WORDS * i + 1] =
          static_cast<uint32_t>(gather) |
          (static_cast<uint32_t>(static_cast<uint8_t>(plane)) << 16) |
          (static_cast<uint32_t>(static_cast<uint8_t>(kind3)) << 24);
      rec[REC_WORDS * i + 2] =
          (keep ? (static_cast<uint32_t>(dst) | KEEP) : 0u) |
          (static_cast<uint32_t>(static_cast<uint8_t>(src_c)) << 24);
    }
    mbar_arrive(s.full + slot);          // one arrival a lane
  }
}

__device__ __forceinline__ int rec_gather(uint32_t w1) {
  return static_cast<int>(w1 & 0xFFFFu);
}
__device__ __forceinline__ int rec_plane(uint32_t w1) {
  return static_cast<int8_t>(w1 >> 16);
}
__device__ __forceinline__ int rec_kind(uint32_t w1) {
  return static_cast<int8_t>(w1 >> 24);
}
__device__ __forceinline__ int rec_src(uint32_t w2) {
  return static_cast<int8_t>(w2 >> 24);
}

// a wear cell's rows: in the ring's space past its half-length stages
__device__ __forceinline__ float* wear_rows(const Smem& s) {
  return reinterpret_cast<float*>(s.ring +
                                  N_STAGES * WEAR_STAGE_OPS * REC_WORDS);
}

// ---------------------------------------------------------------------------
// the recurrence thread: one cell's stream and pad tail
// ---------------------------------------------------------------------------

// The probe's outputs of one cell and where its next window boundary is.
struct Probe {
  float2* head;              // (n_ops,) occupancy fraction, idle claim
  float* snap;               // (W, N_CTR) counters at the boundaries
  float* peak;               // (W,) wear peaks (wear cells)
  long long wo, t_len, next; // ops a window, padded length, next boundary
  int w, n_win;              // next window, window count
};

// the counters (and, for a wear cell, the peak) at window w's boundary
__device__ __forceinline__ void snapshot(Probe& pr, const Carry& c,
                                         bool wear, float peak) {
  float* out = pr.snap + (size_t)pr.w * N_CTR;
#pragma unroll
  for (int i = 0; i < N_CTR; ++i) out[i] = c.ctr[i];
  if (wear) pr.peak[pr.w] = peak;
  ++pr.w;
  pr.next = min(pr.next + pr.wo, pr.t_len - 1);
}

// after op g of the stream: the head columns, and a snapshot if g ends a
// window
__device__ __forceinline__ void observe(Probe& pr, Carry& c, long long g,
                                        const Obs& obs, bool wear) {
  c.occ_pages = c.occ_pages + (float)obs.occ_delta;
  pr.head[g] = make_float2(c.occ_pages, fmaxf(obs.idle_claim, 0.0f));
  if (g == pr.next) snapshot(pr, c, wear, obs.peak);
}

template <int COMP, bool CLOSED, bool ONE_LANE, bool WEAR, bool PROBE>
__device__ __forceinline__ void run_cell(const Args& a, const long long* d,
                                         const Smem& s, int row) {
  static_assert(ONE_LANE || !WEAR, "the wear form is the per-op path");
  Carry c;
  c.busy = s.busy; c.slc = s.slc; c.rp = s.rp; c.trad = s.trad;
  c.vm = s.vm; c.ep = s.ep; c.idle_seen = s.idle_seen;
#pragma unroll
  for (int i = 0; i < N_CTR; ++i) c.ctr[i] = a.ctr[(size_t)row * N_CTR + i];
  c.prev_t = a.prev_t[row];
  c.idle_cum = a.idle_cum[row];
  Knobs kn;
  kn.cap_basic = a.cap_basic[row];
  kn.cap_trad = a.cap_trad[row];
  kn.cap_boost = a.cap_boost[row];
  kn.idle_thr = a.idle_thr[row];
  kn.waste_p = a.waste_p[row];
  const int P = a.P;
  if constexpr (WEAR) {
    const long long wrow = d[Q_WEAR];
    const float* e = a.endur + wrow * N_ENDUR;
    const float* w = a.wear + wrow * wear_words(P);
    kn.w_slc = e[E_W_SLC];
    kn.w_rp = e[E_W_RP];
    kn.w_erase = e[E_W_ERASE];
    kn.cycle_budget = e[E_CYCLE_BUDGET];
    kn.budget_floor = fmaxf(e[E_CYCLE_BUDGET], 1e-9f);
    kn.rp_budget = e[E_RP_BUDGET];
    kn.rp_lo = e[E_RP_BUDGET] - e[E_RP_HYSTERESIS];
    kn.read_penalty = e[E_READ_PENALTY];
    kn.cap_f = fmaxf((float)kn.cap_basic, 1.0f);
    kn.cap_t_f = fmaxf((float)kn.cap_trad, 1.0f);
    kn.per_bucket = fmaxf(kn.cap_f / (float)WEAR_B, 1.0f);
    float* rows = wear_rows(s);
    c.pe_slc = rows;
    c.pe_rp = rows + P * WEAR_B;
    c.pe_tlc = rows + 2 * P * WEAR_B;
    c.erase = c.pe_tlc + P;
    c.pe_trad = c.erase + P;
    c.erase_trad = c.pe_trad + P;
    c.ops_seen = w[2 * P * WEAR_B + 4 * P];
    c.eol_op = w[2 * P * WEAR_B + 4 * P + 1];
  }
  float k[N_FCONST];
#pragma unroll
  for (int i = 0; i < N_FCONST; ++i) k[i] = a.k[i];
  const Divisor ppb = a.ppb;
  float* lat_o = reinterpret_cast<float*>(d[Q_LAT_O]);
  const int K = ONE_LANE ? 1 : static_cast<int>(d[Q_K]);
  const long long n_ops = d[Q_S] * K;
  // the probe's outputs and its first boundary (PROBE only)
  Probe pr;
  Obs obs;
  obs.want_peak = false;
  obs.peak = 0.0f;
  if (PROBE) {
    pr.head = reinterpret_cast<float2*>(d[Q_HEAD]);
    pr.snap = reinterpret_cast<float*>(d[Q_SNAP]);
    pr.peak = reinterpret_cast<float*>(d[Q_PEAK]);
    pr.wo = d[Q_WO];
    pr.t_len = n_ops + d[Q_N_PAD];
    pr.next = min(pr.wo - 1, pr.t_len - 1);
    pr.w = 0;
    pr.n_win = static_cast<int>(max((pr.t_len + pr.wo - 1) / pr.wo, 1LL));
    c.occ_pages = 0.0f;
  }
  const int per_stage = stage_ops_of(K, WEAR);
  const int stride = stage_cap_of(WEAR) * REC_WORDS;
  long long wait_cycles = 0;
  const long long c0 = clock64();

  int st = 0;
  for (long long base = 0; base < n_ops; base += per_stage, ++st) {
    const int slot = st % N_STAGES;
    const long long w0 = clock64();
    mbar_wait(s.full + slot, (st / N_STAGES) & 1);
    wait_cycles += clock64() - w0;
    const int cnt = static_cast<int>(min(static_cast<long long>(per_stage),
                                         n_ops - base));
    const uint32_t* rec = s.ring + slot * stride;
    float* lat = lat_o + base;
    if constexpr (ONE_LANE) {
      // the next op's record is loaded while this op's core runs
      uint32_t n0 = rec[0], n1 = rec[1], n2 = rec[2];
      for (int i = 0; i < cnt; ++i) {
        const uint32_t w0r = n0, w1 = n1, w2 = n2;
        if (i + 1 < cnt) {
          n0 = rec[REC_WORDS * (i + 1)];
          n1 = rec[REC_WORDS * (i + 1) + 1];
          n2 = rec[REC_WORDS * (i + 1) + 2];
        }
        const int g = rec_gather(w1);
        float latency;
        int lv, lev;
        if (PROBE && WEAR) obs.want_peak = base + i == pr.next;
        core<COMP, CLOSED, WEAR, PROBE>(c, kn, k, P, ppb,
                                        __uint_as_float(w0r), rec_plane(w1),
                                        rec_kind(w1), s.loc[g], s.loc_ep[g],
                                        latency, lv, lev, obs);
        lat[i] = latency;
        if (PROBE) observe(pr, c, base + i, obs, WEAR);
        if (w2 & KEEP) {
          const int dst = static_cast<int>(w2 & 0xFFFFu);
          s.loc[dst] = static_cast<int8_t>(lv);
          s.loc_ep[dst] = static_cast<int16_t>(lev);
        }
      }
    } else {
      int* old_k = s.lane;
      int* ep_k = old_k + MAX_LANES;
      int* buf_loc = ep_k + MAX_LANES;
      int* buf_ep = buf_loc + MAX_LANES;
      for (int s0 = 0; s0 < cnt; s0 += K) {
        const uint32_t* r = rec + REC_WORDS * s0;
        // segment-start residency gather (clamped, as the reference's is)
        for (int i = 0; i < K; ++i) {
          const int g = rec_gather(r[REC_WORDS * i + 1]);
          old_k[i] = s.loc[g];
          ep_k[i] = s.loc_ep[g];
        }
        // the lane recurrence, forwarding intra-segment hazards via src
        for (int i = 0; i < K; ++i) {
          const uint32_t w1 = r[REC_WORDS * i + 1];
          const int src = rec_src(r[REC_WORDS * i + 2]);
          const int j = max(src, 0);
          const int old = src >= 0 ? buf_loc[j] : old_k[i];
          const int old_ep = src >= 0 ? buf_ep[j] : ep_k[i];
          float latency;
          int lv, lev;
          core<COMP, CLOSED, false, PROBE>(c, kn, k, P, ppb,
                                           __uint_as_float(r[REC_WORDS * i]),
                                           rec_plane(w1), rec_kind(w1), old,
                                           old_ep, latency, lv, lev, obs);
          lat[s0 + i] = latency;
          if (PROBE) observe(pr, c, base + s0 + i, obs, false);
          buf_loc[i] = lv;
          buf_ep[i] = lev;
        }
        // duplicate-free scatter; out-of-range (superseded) lanes drop
        for (int i = 0; i < K; ++i) {
          const uint32_t w2 = r[REC_WORDS * i + 2];
          if (w2 & KEEP) {
            const int dst = static_cast<int>(w2 & 0xFFFFu);
            s.loc[dst] = static_cast<int8_t>(buf_loc[i]);
            s.loc_ep[dst] = static_cast<int16_t>(buf_ep[i]);
          }
        }
      }
    }
    mbar_arrive(s.empty + slot);
  }

  // the identical tail pads (arrival pad_t, lba 0, is_write -1), applied
  // until one application leaves the carry unchanged or n_pad are done;
  // pads write their residency entry back unchanged, so loc/loc_ep hold
  // (a wear cell has none: it steps every op)
  long long pads = 0;
  if constexpr (!WEAR) {
    const long long n_pad = d[Q_N_PAD];
    if (n_pad > 0) {
      const int old0 = s.loc[0], ep0 = s.loc_ep[0];
      const float pad_t = a.pad_t[row];
      float lat_unused;
      int lv, lev;
      while (pads < n_pad) {
        ++pads;
        const bool changed = core<COMP, CLOSED, false, false>(
            c, kn, k, P, ppb, pad_t, 0, -1, old0, ep0, lat_unused, lv, lev,
            obs);
        // a boundary among the tail pads: the counters there
        if (PROBE && n_ops - 1 + pads == pr.next)
          snapshot(pr, c, false, 0.0f);
        if (!changed) break;
      }
    }
  }
  // boundaries past a fixed point hold the final counters
  if (PROBE)
    while (pr.w < pr.n_win) snapshot(pr, c, false, 0.0f);
  const long long cycles = clock64() - c0;
#pragma unroll
  for (int i = 0; i < N_CTR; ++i) a.ctr_o[(size_t)row * N_CTR + i] = c.ctr[i];
  a.prev_t_o[row] = c.prev_t;
  a.idle_cum_o[row] = c.idle_cum;
  if constexpr (WEAR) {
    float* w = a.wear_o + d[Q_WEAR] * wear_words(P);
    w[2 * P * WEAR_B + 4 * P] = c.ops_seen;
    w[2 * P * WEAR_B + 4 * P + 1] = c.eol_op;
  }
  if (a.timer) {
    long long* t = a.timer + (size_t)row * N_TIMER;
    t[T_SCANNED] = n_ops;
    t[T_PADS] = pads;
    t[T_CYCLES] = cycles;
    t[T_WAIT] = wait_cycles;
  }
}

template <int COMP, bool PROBE>
__device__ __forceinline__ void run_comp(const Args& a, const long long* d,
                                         const Smem& s, int row) {
  const bool closed = d[Q_CLOSED] != 0, one = d[Q_K] == 1;
  if (closed) {
    if (one) run_cell<COMP, true, true, false, PROBE>(a, d, s, row);
    else run_cell<COMP, true, false, false, PROBE>(a, d, s, row);
  } else {
    if (one) run_cell<COMP, false, true, false, PROBE>(a, d, s, row);
    else run_cell<COMP, false, false, false, PROBE>(a, d, s, row);
  }
}

template <int COMP, bool PROBE>
__device__ __forceinline__ void run_comp_wear(const Args& a,
                                              const long long* d,
                                              const Smem& s, int row) {
  if (d[Q_CLOSED] != 0) run_cell<COMP, true, true, true, PROBE>(a, d, s, row);
  else run_cell<COMP, false, true, true, PROBE>(a, d, s, row);
}

// the compositions the kernel instantiates: the 8 valid ones without wear
// bits (either form), and all 16 valid ones in the wear form
#define SSD_PLAIN_COMPS(X)                                                 \
  X(MIGRATE | PRESSURE) X(MIGRATE) X(ADAPTIVE | MIGRATE | PRESSURE)       \
  X(ADAPTIVE | MIGRATE) X(0) X(AGC) X(DUAL) X(DUAL | AGC)
#define SSD_WEAR_COMPS(X)                                                  \
  SSD_PLAIN_COMPS(X) X(GATED) X(GATED | AGC)                               \
  X(WEAR_MIN | MIGRATE | PRESSURE) X(WEAR_MIN | MIGRATE) X(WEAR_MIN)      \
  X(WEAR_MIN | AGC) X(WEAR_MIN | GATED) X(WEAR_MIN | GATED | AGC)

__global__ void __launch_bounds__(BLOCK_THREADS, 1) ssd_fleet_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long t_start = globaltimer();
  const long long* d = a.desc + (size_t)blockIdx.x * N_DESC;
  const int row = static_cast<int>(d[Q_ROW]);
  const long long wrow = d[Q_WEAR];
  const int P = a.P;
  const int N = a.N;
  const Smem s = carve(smem, P, N);

  const size_t pbase = (size_t)row * P;
  const size_t nbase = (size_t)row * N;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    s.busy[i] = a.busy[pbase + i];
    s.slc[i] = a.slc[pbase + i];
    s.rp[i] = a.rp[pbase + i];
    s.trad[i] = a.trad[pbase + i];
    s.vm[i] = a.vm[pbase + i];
    s.ep[i] = a.ep[pbase + i];
    s.idle_seen[i] = a.idle_seen[pbase + i];
  }
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    s.loc[i] = a.loc[nbase + i];
    s.loc_ep[i] = a.loc_ep[nbase + i];
  }
  const int rows_words = 2 * P * WEAR_B + 4 * P;
  if (wrow >= 0) {
    const float* w = a.wear + wrow * wear_words(P);
    float* rows = wear_rows(s);
    for (int i = threadIdx.x; i < rows_words; i += blockDim.x) rows[i] = w[i];
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < N_STAGES; ++i) {
      mbar_init(s.full + i, 32);         // the producer warp's lanes
      mbar_init(s.empty + i, 1);         // the recurrence thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x / 32 == PRODUCER_WARP) {
    produce(d, s, P, N);
  } else if (threadIdx.x == 0) {
    const int comp = static_cast<int>(d[Q_COMP]);
    const bool probe = d[Q_WO] > 0;
    if (wrow >= 0) {
      switch (comp) {
#define SSD_CASE(C)                                                        \
  case C:                                                                  \
    if (probe) run_comp_wear<C, true>(a, d, s, row);                       \
    else run_comp_wear<C, false>(a, d, s, row);                            \
    break;
        SSD_WEAR_COMPS(SSD_CASE)
#undef SSD_CASE
        default: __trap();             // the host refused it
      }
    } else {
      switch (comp) {
#define SSD_CASE(C)                                                        \
  case C:                                                                  \
    if (probe) run_comp<C, true>(a, d, s, row);                            \
    else run_comp<C, false>(a, d, s, row);                                 \
    break;
        SSD_PLAIN_COMPS(SSD_CASE)
#undef SSD_CASE
        default: __trap();             // the host refused it
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    a.busy_o[pbase + i] = s.busy[i];
    a.slc_o[pbase + i] = s.slc[i];
    a.rp_o[pbase + i] = s.rp[i];
    a.trad_o[pbase + i] = s.trad[i];
    a.vm_o[pbase + i] = s.vm[i];
    a.ep_o[pbase + i] = s.ep[i];
    a.idle_seen_o[pbase + i] = s.idle_seen[i];
  }
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    a.loc_o[nbase + i] = s.loc[i];
    a.loc_ep_o[nbase + i] = s.loc_ep[i];
  }
  if (wrow >= 0) {
    float* w = a.wear_o + wrow * wear_words(P);
    const float* rows = wear_rows(s);
    for (int i = threadIdx.x; i < rows_words; i += blockDim.x) w[i] = rows[i];
  }
  if (a.timer) {
    __syncthreads();
    if (threadIdx.x == 0) {
      a.timer[(size_t)row * N_TIMER + T_START] = t_start;
      a.timer[(size_t)row * N_TIMER + T_END] = globaltimer();
    }
  }
}

// The latency of one dependent shared-memory load: one thread chases a
// pointer ring in shared memory `steps` times; out[0] = clock64 cycles,
// out[1] = %globaltimer ns, out[2] = steps, out[3] = the last index (kept
// live so the chase is not optimised away).
constexpr int CHASE_LEN = 1024;

__global__ void smem_chase_kernel(int steps, long long* out) {
  __shared__ int next[CHASE_LEN];
  for (int i = threadIdx.x; i < CHASE_LEN; i += blockDim.x)
    next[i] = (i + 1) % CHASE_LEN;
  __syncthreads();
  if (threadIdx.x == 0) {
    int j = 0;
    const long long t0 = globaltimer();
    const long long c0 = clock64();
    for (int i = 0; i < steps; ++i) j = next[j];
    const long long c1 = clock64();
    const long long t1 = globaltimer();
    out[0] = c1 - c0;
    out[1] = t1 - t0;
    out[2] = steps;
    out[3] = j;
  }
}

bool valid_comp(long long comp, bool wear) {
  switch (comp) {
#define SSD_CASE(C) case C:
    SSD_PLAIN_COMPS(SSD_CASE)
#undef SSD_CASE
      return true;
    case GATED: case GATED | AGC: case WEAR_MIN | MIGRATE | PRESSURE:
    case WEAR_MIN | MIGRATE: case WEAR_MIN: case WEAR_MIN | AGC:
    case WEAR_MIN | GATED: case WEAR_MIN | GATED | AGC:
      return wear;
    default:
      return false;
  }
}

}  // namespace

extern "C" {

// Launch the kernel on `stream`: C blocks, block b running the cell of
// descriptor row b. `ptrs` holds N_PTR device pointers (the timer may be
// 0, and the three wear pointers when no cell tracks wear), `dims` N_DIM
// ints, `consts` N_FCONST floats, `desc_host` the (C, N_DESC) descriptors
// also at ptrs[P_DESC], read here to refuse what the kernel does not take.
// Returns 0, cudaGetLastError() of the launch, or a negative code for
// refused arguments.
int ssd_fleet_launch(const unsigned long long* ptrs, int n_ptrs,
                     const int* dims, int n_dims, const float* consts,
                     int n_consts, const long long* desc_host,
                     unsigned long long stream) {
  if (n_ptrs != N_PTR || n_dims != N_DIM || n_consts != N_FCONST) return -1;
  Args a;
  a.desc = reinterpret_cast<const long long*>(ptrs[P_DESC]);
  a.cap_basic = reinterpret_cast<const int*>(ptrs[P_CAP_BASIC]);
  a.cap_trad = reinterpret_cast<const int*>(ptrs[P_CAP_TRAD]);
  a.cap_boost = reinterpret_cast<const int*>(ptrs[P_CAP_BOOST]);
  a.idle_thr = reinterpret_cast<const float*>(ptrs[P_IDLE_THR]);
  a.waste_p = reinterpret_cast<const float*>(ptrs[P_WASTE_P]);
  a.pad_t = reinterpret_cast<const float*>(ptrs[P_PAD_T]);
  a.busy = reinterpret_cast<const float*>(ptrs[P_BUSY]);
  a.slc = reinterpret_cast<const int*>(ptrs[P_SLC]);
  a.rp = reinterpret_cast<const int*>(ptrs[P_RP]);
  a.trad = reinterpret_cast<const int*>(ptrs[P_TRAD]);
  a.vm = reinterpret_cast<const int*>(ptrs[P_VM]);
  a.ep = reinterpret_cast<const int*>(ptrs[P_EP]);
  a.ctr = reinterpret_cast<const float*>(ptrs[P_CTR]);
  a.prev_t = reinterpret_cast<const float*>(ptrs[P_PREV_T]);
  a.idle_cum = reinterpret_cast<const float*>(ptrs[P_IDLE_CUM]);
  a.idle_seen = reinterpret_cast<const float*>(ptrs[P_IDLE_SEEN]);
  a.loc = reinterpret_cast<const int8_t*>(ptrs[P_LOC]);
  a.loc_ep = reinterpret_cast<const int16_t*>(ptrs[P_LOC_EP]);
  a.busy_o = reinterpret_cast<float*>(ptrs[P_BUSY_O]);
  a.slc_o = reinterpret_cast<int*>(ptrs[P_SLC_O]);
  a.rp_o = reinterpret_cast<int*>(ptrs[P_RP_O]);
  a.trad_o = reinterpret_cast<int*>(ptrs[P_TRAD_O]);
  a.vm_o = reinterpret_cast<int*>(ptrs[P_VM_O]);
  a.ep_o = reinterpret_cast<int*>(ptrs[P_EP_O]);
  a.ctr_o = reinterpret_cast<float*>(ptrs[P_CTR_O]);
  a.prev_t_o = reinterpret_cast<float*>(ptrs[P_PREV_T_O]);
  a.idle_cum_o = reinterpret_cast<float*>(ptrs[P_IDLE_CUM_O]);
  a.idle_seen_o = reinterpret_cast<float*>(ptrs[P_IDLE_SEEN_O]);
  a.loc_o = reinterpret_cast<int8_t*>(ptrs[P_LOC_O]);
  a.loc_ep_o = reinterpret_cast<int16_t*>(ptrs[P_LOC_EP_O]);
  a.timer = reinterpret_cast<long long*>(ptrs[P_TIMER]);
  a.endur = reinterpret_cast<const float*>(ptrs[P_ENDUR]);
  a.wear = reinterpret_cast<const float*>(ptrs[P_WEAR]);
  a.wear_o = reinterpret_cast<float*>(ptrs[P_WEAR_O]);
  a.C = dims[D_C]; a.P = dims[D_P]; a.N = dims[D_N];
  for (int i = 0; i < N_FCONST; ++i) a.k[i] = consts[i];
  if (a.C <= 0 || a.P <= 0 || a.P > 128 || a.N <= 0 || a.N > MAX_PAGES ||
      dims[D_PPB] <= 0 || desc_host == nullptr || a.desc == nullptr)
    return -2;
  a.ppb = make_divisor(dims[D_PPB]);
  // a wear cell's rows must fit the ring space its half-length stages free
  const bool wear_fits =
      4LL * (2LL * a.P * WEAR_B + 4LL * a.P) <=
      (long long)RING_BYTES - 4LL * N_STAGES * WEAR_STAGE_OPS * REC_WORDS;
  for (int b = 0; b < a.C; ++b) {
    const long long* d = desc_host + (size_t)b * N_DESC;
    const bool wear = d[Q_WEAR] >= 0;
    if (!valid_comp(d[Q_COMP], wear)) return -4;
    if (d[Q_K] < 1 || d[Q_K] > MAX_LANES || d[Q_S] < 0 || d[Q_N_PAD] < 0 ||
        d[Q_ROW] < 0 || d[Q_ROW] >= a.C || (d[Q_CLOSED] != 0 && d[Q_CLOSED] != 1))
      return -2;
    if (d[Q_K] > 1 && (d[Q_SRC] == 0 || d[Q_SCAT] == 0)) return -3;
    if (d[Q_S] > 0 && (d[Q_ARRIVAL] == 0 || d[Q_LBA] == 0 ||
                       d[Q_IS_WRITE] == 0 || d[Q_LAT_O] == 0))
      return -2;
    if (wear && (d[Q_K] != 1 || d[Q_N_PAD] != 0 || !wear_fits ||
                 a.endur == nullptr || a.wear == nullptr ||
                 a.wear_o == nullptr))
      return -6;
    // the probe's outputs: head columns for a stream, snapshots always,
    // peaks for a wear cell
    if (d[Q_WO] < 0) return -2;
    if (d[Q_WO] > 0 && ((d[Q_S] > 0 && d[Q_HEAD] == 0) || d[Q_SNAP] == 0 ||
                        (wear && d[Q_PEAK] == 0)))
      return -7;
  }
  const size_t smem = (size_t)block_bytes(a.P, a.N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fleet_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_fleet_kernel<<<a.C, BLOCK_THREADS, smem,
                     reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The dependent shared-memory load latency probe (smem_chase_kernel):
// `out` is a device pointer to 4 int64.
int ssd_smem_chase(int steps, unsigned long long out,
                   unsigned long long stream) {
  if (steps <= 0 || out == 0) return -1;
  smem_chase_kernel<<<1, 32, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      steps, reinterpret_cast<long long*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
