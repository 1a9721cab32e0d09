// ssd_step.cu — the hybrid-SSD simulator's per-op recurrence for a whole
// fleet of cells in one launch, written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_segment_stream_kernel` of the reference package
// (src/repro/kernels/ssd_step/kernel.py:46, launched by
// `run_segments_kernel`): one cell's (S, K) compressed-segment stream with
// the residency maps held in fast memory. This kernel runs C cells at once,
// one thread block per cell, and takes both stream forms: the per-op
// stream (K = 1, src = -1, scat_lba = lba — passed as null pointers) and
// the K-lane segment stream with its hazard plan. After the stream it
// replays the cell's `n_pad` identical tail pads to their exact fixed point
// in-kernel, as the reference's `sim.replay_pads` does.
//
// What bounds it on this card: the longest cell's dependent op chain. Every
// op reads the plane state the previous op wrote, so a cell is one serial
// recurrence of a few hundred dependent instructions per op; the bytes are
// small (12 bytes of op stream and 4 of latency per op, plus 200 KB of carry
// in and out per cell — some 240 MB for the paper grid, about 70 us at
// 3.35 TB/s). The design keeps the whole recurrence out of device memory:
// the cell's residency maps (`loc` int8, 64 KB, and `loc_ep` int16, 128 KB,
// over 2^16 pages) and its 128-plane carry (3.5 KB) live in dynamic shared
// memory, about 200 KB of the 227 KB a block may use, so every gather,
// scatter and plane update is a shared-memory access. The block's threads
// load and store the maps cooperatively; one thread runs the recurrence. A
// launch of C cells occupies C of the 132 SMs. Shortening the chain (the op
// stream is read from device memory op by op) and running a sweep's
// launches side by side are later work.
//
// Bit identity with the reference. The reference's compiler (XLA on the
// CPU) fuses exactly four of the core's multiply-adds into FMA
// instructions: `budget - mig * c_mig` (migrate), `budget - ops1 *
// c_trad_rp` and `budget - ops2 * c_mig` (dual reclaim) and `agc_waste +
// ops * waste_p` (AGC). Those four are written as __fmaf_rn here, and the
// file is built with -fmad=false so that nvcc fuses nothing else: `used_ms
// + erase_total` (migrate) rounds `mig * c_mig` first, as there. Float
// division is IEEE (no fast math) and is truncated to int32 as the
// reference's astype does. The composition's constants arrive from the wrapper already rounded once
// from Python doubles to float32, the rounding the reference's weak-typed
// Python floats get. Packed int16 plane fields are widened to int32 by the
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
constexpr int BLOCK_THREADS = 256;

// composition bits (the wrapper's `composition_code`)
constexpr int DUAL = 1, ADAPTIVE = 2, MIGRATE = 4, PRESSURE = 8, AGC = 16;

// float constants, in the order of the wrapper's `kernel_constants`
enum {
  K_C_MIG = 0, K_C_AGC, K_C_TRAD_RP, K_OVERRUN_MS, K_AGC_HALF, K_ERASE_MS,
  K_SLC_READ, K_TLC_READ, K_SLC_WRITE, K_TLC_WRITE, K_REPROGRAM, N_FCONST
};

// pointer table, in the order of the wrapper's `_PTR_ORDER`
enum {
  P_ARRIVAL = 0, P_LBA, P_IS_WRITE, P_SRC, P_SCAT,
  P_CAP_BASIC, P_CAP_TRAD, P_CAP_BOOST, P_IDLE_THR, P_WASTE_P, P_PAD_T,
  P_BUSY, P_SLC, P_RP, P_TRAD, P_VM, P_EP, P_CTR, P_PREV_T, P_IDLE_CUM,
  P_IDLE_SEEN, P_LOC, P_LOC_EP,
  P_LAT_O, P_BUSY_O, P_SLC_O, P_RP_O, P_TRAD_O, P_VM_O, P_EP_O, P_CTR_O,
  P_PREV_T_O, P_IDLE_CUM_O, P_IDLE_SEEN_O, P_LOC_O, P_LOC_EP_O, N_PTR
};

// integer dims, in the order of the wrapper's `_DIM_ORDER`
enum { D_COMP = 0, D_CLOSED, D_C, D_S, D_K, D_P, D_N, D_N_PAD, D_PPB, N_DIM };

struct Args {
  const float* arrival; const int* lba; const int* is_write;
  const int* src; const int* scat;               // null: per-op stream
  const int* cap_basic; const int* cap_trad; const int* cap_boost;
  const float* idle_thr; const float* waste_p; const float* pad_t;
  const float* busy; const int* slc; const int* rp; const int* trad;
  const int* vm; const int* ep; const float* ctr; const float* prev_t;
  const float* idle_cum; const float* idle_seen;
  const int8_t* loc; const int16_t* loc_ep;
  float* lat_o; float* busy_o; int* slc_o; int* rp_o; int* trad_o;
  int* vm_o; int* ep_o; float* ctr_o; float* prev_t_o; float* idle_cum_o;
  float* idle_seen_o; int8_t* loc_o; int16_t* loc_ep_o;
  int C, S, K, P, N, n_pad, ppb_slc;
  float k[N_FCONST];
};

// One cell's carry while its thread runs the recurrence: plane arrays in
// shared memory, the counters and the two idle scalars in registers.
struct Carry {
  float* busy; int* slc; int* rp; int* trad; int* vm; int* ep;
  float* idle_seen;
  float ctr[N_CTR];
  float prev_t, idle_cum;
};

struct Knobs {
  int cap_basic, cap_trad, cap_boost;
  float idle_thr, waste_p;
};

template <int COMP>
__device__ __forceinline__ int eff_cap(int slc_used, const Knobs& kn) {
  if (COMP & ADAPTIVE) {
    const bool above = slc_used >= (WATERMARK_NUM * kn.cap_basic) / WATERMARK_DEN;
    return above ? kn.cap_basic + kn.cap_boost : kn.cap_basic;
  }
  return kn.cap_basic;
}

__device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The per-op core (the reference engine's `_build_core`), in its fragment
// order. Reads the plane state, computes, then writes it back; returns
// whether any carry value changed (the fixed-point test of the tail replay).
template <int COMP, bool CLOSED>
__device__ __forceinline__ bool core(
    Carry& c, const Knobs& kn, const float* __restrict__ k, int P, int ppb,
    float t, int lba, int kind, int old_raw, int old_ep,
    float& latency_out, int& loc_val_out, int& loc_ep_val_out) {
  constexpr bool dual = COMP & DUAL;
  constexpr bool run_migrate = COMP & MIGRATE;
  constexpr bool use_rp = !run_migrate;
  constexpr bool pressure = COMP & PRESSURE;
  constexpr bool run_agc = COMP & AGC;
  constexpr bool run_dual_reclaim = dual && run_agc;

  const int plane = lba % P;
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
      const int mig = min(valid_mig, (int)(budget / k[K_C_MIG]));
      valid_mig = valid_mig - mig;
      float used_ms = (float)mig * k[K_C_MIG];
      budget = __fmaf_rn(-(float)mig, k[K_C_MIG], budget);  // fused there
      ctr[CTR_MIG_W] = ctr[CTR_MIG_W] + (float)mig;
      const int blocks = ceil_div(slc_used, ppb);
      const float erase_total = (float)blocks * k[K_ERASE_MS];
      const bool can_erase = valid_mig == 0 && slc_used > 0 && budget >= erase_total;
      ctr[CTR_ERASES] = ctr[CTR_ERASES] + (float)(can_erase ? blocks : 0);
      epoch_p = epoch_p + (can_erase ? 1 : 0);
      slc_used = can_erase ? 0 : slc_used;
      used_ms = used_ms + (can_erase ? erase_total : 0.0f);
      if (pressure) {
        // overrun beyond the real gap stalls the arriving write
        conflict = conflict + ((above_wm && is_write)
                               ? fmaxf(used_ms - full_gap, 0.0f) : 0.0f);
      }
    }
    if (run_dual_reclaim) {
      float budget = dev_budget;
      int rp_avail = 2 * slc_used - rp_done;
      const int ops1 = min(min(valid_mig, rp_avail), (int)(budget / k[K_C_TRAD_RP]));
      rp_done = rp_done + ops1;
      valid_mig = valid_mig - ops1;
      budget = __fmaf_rn(-(float)ops1, k[K_C_TRAD_RP], budget);
      ctr[CTR_RP_TRAD] = ctr[CTR_RP_TRAD] + (float)ops1;
      rp_avail = 2 * slc_used - rp_done;
      const int ops2 = min(rp_avail == 0 ? valid_mig : 0, (int)(budget / k[K_C_MIG]));
      valid_mig = valid_mig - ops2;
      budget = __fmaf_rn(-(float)ops2, k[K_C_MIG], budget);
      ctr[CTR_MIG_W] = ctr[CTR_MIG_W] + (float)ops2;
      const int blocks = ceil_div(trad_used, ppb);
      const bool can_erase = valid_mig == 0 && trad_used > 0 &&
                             budget >= (float)blocks * k[K_ERASE_MS];
      ctr[CTR_ERASES] = ctr[CTR_ERASES] + (float)(can_erase ? blocks : 0);
      epoch_p = epoch_p + (can_erase ? 1 : 0);
      trad_used = can_erase ? 0 : trad_used;
    }
    if (run_agc) {
      int rp_avail = 2 * slc_used - rp_done;
      if (dual) rp_avail = valid_mig == 0 ? rp_avail : 0;
      const int ops = min(rp_avail, (int)(full_gap / k[K_C_AGC]));
      rp_done = rp_done + ops;
      const float opsf = (float)ops;
      ctr[CTR_RP_AGC] = ctr[CTR_RP_AGC] + opsf;
      ctr[CTR_AGC_WASTE] = __fmaf_rn(opsf, kn.waste_p, ctr[CTR_AGC_WASTE]);
      const bool agc_active = (2 * slc_used - rp_done) > 0;
      conflict = conflict + ((agc_active && is_write) ? k[K_AGC_HALF] : 0.0f);
    }
  }

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
                     (2 * slc_used - rp_done) > 0;
  const bool to_tlc = is_write && !to_slc && !to_trad && !to_rp;

  const float prog_t = (to_slc || to_trad) ? k[K_SLC_WRITE]
                       : (to_rp ? k[K_REPROGRAM] : k[K_TLC_WRITE]);
  const float read_t = old_ok ? k[K_SLC_READ] : k[K_TLC_READ];
  float service = is_write ? prog_t : read_t;
  service = is_pad ? 0.0f : service;
  const float latency = is_pad ? 0.0f : wait + conflict + service;
  const float busy_new = is_pad ? busy_p : start + service;

  // bookkeeping
  slc_used = slc_used + (to_slc ? 1 : 0);
  trad_used = trad_used + (to_trad ? 1 : 0);
  rp_done = rp_done + (to_rp ? 1 : 0);
  // residency tracking covers exactly the migratable region
  const bool track_new = run_migrate ? (to_slc || to_rp) : (dual ? to_trad : false);
  const int valid_dec = (is_write && old_ok) ? 1 : 0;

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

template <int COMP, bool CLOSED>
__global__ void __launch_bounds__(BLOCK_THREADS) ssd_stream_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cell = blockIdx.x;
  const int P = a.P;
  const int N = a.N;
  float* busy = reinterpret_cast<float*>(smem);
  int* slc = reinterpret_cast<int*>(busy + P);
  int* rp = slc + P;
  int* trad = rp + P;
  int* vm = trad + P;
  int* ep = vm + P;
  float* idle_seen = reinterpret_cast<float*>(ep + P);
  int16_t* loc_ep = reinterpret_cast<int16_t*>(idle_seen + P);
  int8_t* loc = reinterpret_cast<int8_t*>(loc_ep + N);

  const size_t pbase = (size_t)cell * P;
  const size_t nbase = (size_t)cell * N;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    busy[i] = a.busy[pbase + i];
    slc[i] = a.slc[pbase + i];
    rp[i] = a.rp[pbase + i];
    trad[i] = a.trad[pbase + i];
    vm[i] = a.vm[pbase + i];
    ep[i] = a.ep[pbase + i];
    idle_seen[i] = a.idle_seen[pbase + i];
  }
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    loc[i] = a.loc[nbase + i];
    loc_ep[i] = a.loc_ep[nbase + i];
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    Carry c;
    c.busy = busy; c.slc = slc; c.rp = rp; c.trad = trad; c.vm = vm;
    c.ep = ep; c.idle_seen = idle_seen;
#pragma unroll
    for (int i = 0; i < N_CTR; ++i) c.ctr[i] = a.ctr[(size_t)cell * N_CTR + i];
    c.prev_t = a.prev_t[cell];
    c.idle_cum = a.idle_cum[cell];
    Knobs kn;
    kn.cap_basic = a.cap_basic[cell];
    kn.cap_trad = a.cap_trad[cell];
    kn.cap_boost = a.cap_boost[cell];
    kn.idle_thr = a.idle_thr[cell];
    kn.waste_p = a.waste_p[cell];
    const int K = a.K;
    int old_k[MAX_LANES], ep_k[MAX_LANES], buf_loc[MAX_LANES], buf_ep[MAX_LANES];
    float lat_unused;

    for (int s = 0; s < a.S; ++s) {
      const size_t base = ((size_t)cell * a.S + s) * K;
      // segment-start residency gather (clamped, as the reference's is)
      for (int i = 0; i < K; ++i) {
        const int l = min(max(__ldg(a.lba + base + i), 0), N - 1);
        old_k[i] = loc[l];
        ep_k[i] = loc_ep[l];
      }
      // the lane recurrence, forwarding intra-segment hazards via src
      for (int i = 0; i < K; ++i) {
        const int src = a.src ? __ldg(a.src + base + i) : -1;
        const int j = min(max(src, 0), K - 1);
        const int old = src >= 0 ? buf_loc[j] : old_k[i];
        const int old_ep = src >= 0 ? buf_ep[j] : ep_k[i];
        core<COMP, CLOSED>(c, kn, a.k, P, a.ppb_slc, __ldg(a.arrival + base + i),
                           __ldg(a.lba + base + i), __ldg(a.is_write + base + i),
                           old, old_ep, a.lat_o[base + i], buf_loc[i], buf_ep[i]);
      }
      // duplicate-free scatter; out-of-range (superseded) lanes drop
      for (int i = 0; i < K; ++i) {
        const int dst = a.scat ? __ldg(a.scat + base + i) : __ldg(a.lba + base + i);
        if (dst >= 0 && dst < N) {
          loc[dst] = (int8_t)buf_loc[i];
          loc_ep[dst] = (int16_t)buf_ep[i];
        }
      }
    }

    // the identical tail pads (arrival pad_t, lba 0, is_write -1), applied
    // until one application leaves the carry unchanged or n_pad are done;
    // pads write their residency entry back unchanged, so loc/loc_ep hold
    if (a.n_pad > 0) {
      const int old0 = loc[0], ep0 = loc_ep[0];
      const float pad_t = a.pad_t[cell];
      int lv, lev;
      for (int i = 0; i < a.n_pad; ++i) {
        if (!core<COMP, CLOSED>(c, kn, a.k, P, a.ppb_slc, pad_t, 0, -1, old0, ep0,
                                lat_unused, lv, lev)) break;
      }
    }
#pragma unroll
    for (int i = 0; i < N_CTR; ++i) a.ctr_o[(size_t)cell * N_CTR + i] = c.ctr[i];
    a.prev_t_o[cell] = c.prev_t;
    a.idle_cum_o[cell] = c.idle_cum;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    a.busy_o[pbase + i] = busy[i];
    a.slc_o[pbase + i] = slc[i];
    a.rp_o[pbase + i] = rp[i];
    a.trad_o[pbase + i] = trad[i];
    a.vm_o[pbase + i] = vm[i];
    a.ep_o[pbase + i] = ep[i];
    a.idle_seen_o[pbase + i] = idle_seen[i];
  }
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    a.loc_o[nbase + i] = loc[i];
    a.loc_ep_o[nbase + i] = loc_ep[i];
  }
}

template <int COMP, bool CLOSED>
int launch(const Args& a, size_t smem, cudaStream_t stream) {
  auto kern = ssd_stream_kernel<COMP, CLOSED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<a.C, BLOCK_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int COMP>
int launch_mode(const Args& a, bool closed, size_t smem, cudaStream_t stream) {
  return closed ? launch<COMP, true>(a, smem, stream)
                : launch<COMP, false>(a, smem, stream);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one cell needs.
long long ssd_stream_smem_bytes(int P, int N) {
  return 7LL * 4 * P + 2LL * N + (long long)N;
}

// Launch the kernel on `stream`. `ptrs` holds N_PTR device pointers (src and
// scat may be 0: the per-op stream), `dims` N_DIM ints, `consts` N_FCONST
// floats. Returns 0, cudaGetLastError() of the launch, or a negative code
// for arguments the kernel does not take.
int ssd_stream_launch(const unsigned long long* ptrs, int n_ptrs,
                      const int* dims, int n_dims, const float* consts,
                      int n_consts, unsigned long long stream) {
  if (n_ptrs != N_PTR || n_dims != N_DIM || n_consts != N_FCONST) return -1;
  Args a;
  a.arrival = reinterpret_cast<const float*>(ptrs[P_ARRIVAL]);
  a.lba = reinterpret_cast<const int*>(ptrs[P_LBA]);
  a.is_write = reinterpret_cast<const int*>(ptrs[P_IS_WRITE]);
  a.src = reinterpret_cast<const int*>(ptrs[P_SRC]);
  a.scat = reinterpret_cast<const int*>(ptrs[P_SCAT]);
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
  a.lat_o = reinterpret_cast<float*>(ptrs[P_LAT_O]);
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
  a.C = dims[D_C]; a.S = dims[D_S]; a.K = dims[D_K]; a.P = dims[D_P];
  a.N = dims[D_N]; a.n_pad = dims[D_N_PAD]; a.ppb_slc = dims[D_PPB];
  for (int i = 0; i < N_FCONST; ++i) a.k[i] = consts[i];
  if (a.C <= 0 || a.K <= 0 || a.K > MAX_LANES || a.S < 0 || a.P <= 0 ||
      a.P > 128 || a.N <= 0 || a.n_pad < 0 || a.ppb_slc <= 0) return -2;
  if (a.K > 1 && (a.src == nullptr || a.scat == nullptr)) return -3;
  const size_t smem = (size_t)ssd_stream_smem_bytes(a.P, a.N);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool closed = dims[D_CLOSED] != 0;
  switch (dims[D_COMP]) {
    case MIGRATE | PRESSURE: return launch_mode<MIGRATE | PRESSURE>(a, closed, smem, st);
    case MIGRATE: return launch_mode<MIGRATE>(a, closed, smem, st);
    case ADAPTIVE | MIGRATE | PRESSURE:
      return launch_mode<ADAPTIVE | MIGRATE | PRESSURE>(a, closed, smem, st);
    case ADAPTIVE | MIGRATE: return launch_mode<ADAPTIVE | MIGRATE>(a, closed, smem, st);
    case 0: return launch_mode<0>(a, closed, smem, st);
    case AGC: return launch_mode<AGC>(a, closed, smem, st);
    case DUAL: return launch_mode<DUAL>(a, closed, smem, st);
    case DUAL | AGC: return launch_mode<DUAL | AGC>(a, closed, smem, st);
    default: return -4;
  }
}

}  // extern "C"
