"""Wrapper of the `ssd_step` CUDA kernel (`csrc/ssd_step.cu`): build,
load, argument checks, launch, launch count and CUDA events.

`run_streams(cfg, jobs)` runs any number of jobs in ONE launch, one
thread block per cell. A job (`StreamJob`) is one fleet of cells that
share a composition, a mode and a stream shape: their op streams — the
per-op form (K = 1, no hazard plan) or the (S, K) segment form — and each
cell's pad-tail replay. Jobs may differ in all of that. A job whose
cells track wear (`params.endurance` set, `state0.wear` present) runs the
kernel's wear form: the per-op stream, no pad tail (it steps every op),
its `WearState` carried in and out. A job that sets `window_ops` runs
the kernel's probe form: its cells' final states carry the telemetry
probe's `ProbeRows` in `timeline` (head columns per scanned op, counter
snapshots and, with wear, peak cycles at each window boundary, the pad
tail's included). `run_stream` is the one-job case. For tensors on a
CUDA device the wrapper launches the kernel or raises; tensors on the
CPU go to the plain version, `ref.run_stream_ref`, job by job. Nothing
falls back.

The kernel is built at first use by `kernels._build` (nvcc into
`build/kernels/`, loaded with ctypes), with `-fmad=false`: the kernel
fuses exactly the reference's multiply-adds itself (ROADMAP §C).

`specialisations()` counts the distinct `run_cell<COMP, CLOSED,
ONE_LANE, WEAR, PROBE>` instantiations the process's jobs have asked for
so far (recorded for every job `run_streams` takes, the plain version's
too): the port's counterpart of the reference's `fleet.compile_count`,
which grows with the specialised programs a sweep needs and never with
its knobs.
"""
from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.ssd.endurance.model import (EnduranceParams,
                                                  WearState)
from repro_torch.core.ssd.policies.allocation import ALLOCATIONS
from repro_torch.core.ssd.policies.engine import (check_composition,
                                                  core_constants)
from repro_torch.core.ssd.policies.registry import resolve_spec
from repro_torch.core.ssd.policies.state import (CTR, OVERRUN_PAGES,
                                                 SimState)
from repro_torch.kernels._build import (BASE_FLAGS, LINK_FLAGS, Launcher,
                                        Library, check, kernel_route,
                                        refuse_grad)
from repro_torch.kernels.ssd_step import ref
from repro_torch.telemetry import probe
from repro_torch.telemetry.probe import ProbeRows

__all__ = ["StreamJob", "run_streams", "run_stream", "smem_chase", "reset",
           "launches", "events", "composition_code", "kernel_constants",
           "smem_bytes", "block_smem_bytes", "specialisations",
           "specialisation_keys",
           "MAX_LANES", "MAX_PAGES", "WEAR_BUCKETS", "TIMER_COLUMNS",
           "SOURCE", "NVCC_FLAGS", "LIB", "LAUNCHER"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "ssd_step.cu")
NVCC_FLAGS = BASE_FLAGS + ("-fmad=false",) + LINK_FLAGS
MAX_LANES = 32
MAX_PAGES = 1 << 16         # the op ring's 16-bit page index
MAX_SMEM = 232448           # bytes of shared memory a block may use
# the block's shared memory beyond the cell's carry: four lane buffers of
# MAX_LANES ints, two stages' full/empty mbarriers, and the op ring of two
# stages x 1,024 ops x 12 bytes (csrc/ssd_step.cu)
STAGING_BYTES = 4 * 4 * MAX_LANES + 8 * 2 * 2 + 2 * 1024 * 12
# a wear cell's ring stages hold 512 ops, and its wear rows take the ring
# space that frees: 2 x 512 x 12 bytes of the 2 x 1,024 x 12
WEAR_RING_FREE = 2 * 1024 * 12 - 2 * 512 * 12
WEAR_BUCKETS = 8            # the wear buckets a kernel row holds
# what each block writes into the optional (C, 6) int64 timer, by column
TIMER_COLUMNS = ("start_ns", "end_ns", "scanned_ops", "pads_replayed",
                 "cycles", "wait_cycles")

# argument tables, in the order csrc/ssd_step.cu reads them
_PTR_ORDER = (
    "desc", "cap_basic", "cap_trad", "cap_boost", "idle_thr", "waste_p",
    "pad_t", "busy", "slc_used", "rp_done", "trad_used", "valid_mig",
    "epoch", "counters", "prev_t", "idle_cum", "idle_seen", "loc", "loc_ep",
    "busy_o", "slc_used_o", "rp_done_o", "trad_used_o", "valid_mig_o",
    "epoch_o", "counters_o", "prev_t_o", "idle_cum_o", "idle_seen_o",
    "loc_o", "loc_ep_o", "timer", "endur", "wear", "wear_o")
_DESC_ORDER = ("arrival_ms", "lba", "is_write", "src", "scat_lba", "lat_o",
               "comp", "closed", "S", "K", "n_pad", "row", "wear",
               "window_ops", "head", "snap", "peak")
_DIM_ORDER = ("C", "P", "N", "ppb")
_N_FCONST = 15
_WIDENED = ("slc_used", "rp_done", "trad_used", "valid_mig", "epoch")
# the carry's base fields, by name: `wear` and `timeline` trail them and
# travel in tables of their own
_BASE_STATE = ("busy", "slc_used", "rp_done", "trad_used", "valid_mig",
               "epoch", "loc", "loc_ep", "counters", "prev_t", "idle_cum",
               "idle_seen")
_BASE_PARAMS = ("cap_basic", "cap_trad", "cap_boost", "idle_thr", "waste_p")
# a wear cell's state packed into one float32 row, in this order
# (`wear_words` of csrc/ssd_step.cu)
_WEAR_ORDER = WearState._fields


class StreamJob(NamedTuple):
    """One `run_stream` call's arguments: C cells of one composition and
    mode. `segs`: (C, S, K) `arrival_ms` f32, `lba` i32, `is_write` i32,
    and for K > 1 the hazard plan `src`/`scat_lba` i32 (without it the
    stream is the per-op form, K = 1). `state0`: SimState with a leading
    cell axis, packed or unpacked. `params`: CellParams of (C,) tensors.
    `pad_t`: (C,) f32 arrival of each cell's `n_pad` identical tail
    pads. Cells that track wear carry `state0.wear` and
    `params.endurance` and take the per-op form with no pad tail.
    `window_ops` (ops a telemetry window, None: off) turns the probe on;
    the windows tile each cell's padded length S x K + n_pad."""
    policy: object
    segs: dict
    state0: SimState
    closed_loop: bool
    params: object
    n_pad: int = 0
    pad_t: Optional[torch.Tensor] = None
    window_ops: Optional[int] = None


def composition_code(spec) -> int:
    """The kernel's template selector for a composition (the bits of
    csrc/ssd_step.cu: DUAL 1, ADAPTIVE 2, MIGRATE 4, PRESSURE 8, AGC 16,
    GATED 32, WEAR_MIN 64; the last two only in the wear form)."""
    return ((1 if ALLOCATIONS[spec.allocation].dual else 0)
            | (2 if spec.allocation == "adaptive" else 0)
            | (4 if spec.mechanism == "migrate" else 0)
            | (8 if spec.trigger == "watermark" else 0)
            | (16 if spec.idle == "agc" else 0)
            | (32 if spec.mechanism == "reprogram_gated" else 0)
            | (64 if spec.allocation == "wear_min" else 0))


def kernel_constants(cfg) -> np.ndarray:
    """The float constants of the core, computed in Python doubles and
    rounded once to float32 — what the reference's weak-typed Python
    floats become where they meet a float32 value."""
    k = core_constants(cfg)
    t_ = cfg.timing
    return np.array([k["c_mig"], k["c_agc"], k["c_trad_rp"],
                     OVERRUN_PAGES * k["c_mig"], k["c_agc"] * 0.5,
                     k["erase_ms"], t_.slc_read_ms, t_.tlc_read_ms,
                     t_.slc_write_ms, t_.tlc_write_ms, t_.reprogram_ms,
                     k["inv_c_mig"], k["inv_c_agc"], k["inv_c_trad_rp"],
                     k["inv_buckets"]], dtype=np.float32)


def smem_bytes(n_planes: int, n_logical: int) -> int:
    """Shared memory of one cell's carry: the seven (P,) plane arrays,
    `loc_ep` int16 and `loc` int8."""
    return 7 * 4 * n_planes + 3 * n_logical


def block_smem_bytes(n_planes: int, n_logical: int) -> int:
    """Dynamic shared memory one cell's block needs: the carry (16-byte
    aligned), then the lane buffers, the ring's barriers and its stages
    (`block_bytes` of csrc/ssd_step.cu)."""
    return -(-smem_bytes(n_planes, n_logical) // 16) * 16 + STAGING_BYTES


def _wear_words(n_planes: int) -> int:
    """Floats of one wear cell's packed state: pe_slc and pe_rp (P, 8),
    the four (P,) rows, ops_seen and eol_op."""
    return 2 * n_planes * WEAR_BUCKETS + 4 * n_planes + 2


def _wear_fits(n_planes: int) -> bool:
    """Whether a wear cell's rows fit the ring space its half-length
    stages free (10,240 of 12,288 bytes at 128 planes)."""
    return 4 * (_wear_words(n_planes) - 2) <= WEAR_RING_FREE


def _pack_wear(wear: WearState) -> torch.Tensor:
    """(C, _wear_words) float32 rows of a fleet's WearState."""
    c_cnt = wear.ops_seen.shape[0]
    return torch.cat([getattr(wear, f).reshape(c_cnt, -1)
                      for f in _WEAR_ORDER], dim=1).contiguous()


def _unpack_wear(rows: torch.Tensor, n_planes: int) -> WearState:
    c_cnt, p, b = rows.shape[0], n_planes, WEAR_BUCKETS
    sizes = (p * b, p * b, p, p, p, p, 1, 1)
    parts = torch.split(rows, sizes, dim=1)
    shapes = ((c_cnt, p, b), (c_cnt, p, b), (c_cnt, p), (c_cnt, p),
              (c_cnt, p), (c_cnt, p), (c_cnt,), (c_cnt,))
    return WearState(*(x.reshape(s) for x, s in zip(parts, shapes)))


def _bind(lib) -> None:
    lib.ssd_fleet_launch.argtypes = [
        ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_ulonglong]
    lib.ssd_fleet_launch.restype = ctypes.c_int
    lib.ssd_smem_chase.argtypes = [ctypes.c_int, ctypes.c_ulonglong,
                                   ctypes.c_ulonglong]
    lib.ssd_smem_chase.restype = ctypes.c_int


LIB = Library("ssd_step", SOURCE, NVCC_FLAGS, _bind)
# every launch is bracketed by CUDA events: the sweep runner reads the
# launch's kernel time from them
LAUNCHER = Launcher(LIB, "ssd_step")
LAUNCHER.record = True


# the run_cell keys the process's jobs asked for: (composition code,
# closed loop, one lane, wear, probe)
_SPECIALISATIONS: set = set()


def reset() -> None:
    """Zero the launch count and drop the recorded launch events."""
    LAUNCHER.reset()


def specialisations() -> int:
    """Distinct kernel specialisations the process's jobs have needed."""
    return len(_SPECIALISATIONS)


def specialisation_keys() -> frozenset:
    """The specialisations the process's jobs have needed (their keys)."""
    return frozenset(_SPECIALISATIONS)


def __getattr__(name):
    # `launches` (launches since the last reset(); the plain version and
    # argument errors never count) and `events` ((start, end) CUDA events
    # of each of those launches) are the launcher's
    if name in ("launches", "events"):
        return getattr(LAUNCHER, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _check_job(cfg, job: StreamJob, dev, n_logical: int) -> dict:
    """Raise unless the kernel takes `job` on `dev`; returns its
    composition code, shape and pad arrival."""
    spec = resolve_spec(job.policy)
    check_composition(spec, job.params)
    code = composition_code(spec)
    segs, state0, params = job.segs, job.state0, job.params
    wear = params.endurance is not None
    if wear != (state0.wear is not None):
        raise ValueError("ssd_step: a job's cells carry wear state exactly "
                         "when their params set endurance knobs")
    lba = segs["lba"]
    if lba.dim() != 3:
        raise ValueError(f"ssd_step: segs must be (C, S, K), got "
                         f"{tuple(lba.shape)}")
    c_cnt, s_cnt, k = lba.shape
    p = cfg.num_planes
    if c_cnt < 1:
        raise ValueError("ssd_step: a job needs at least one cell")
    if not 1 <= k <= MAX_LANES:
        raise ValueError(f"ssd_step: K = {k} lanes; the kernel takes 1.."
                         f"{MAX_LANES}")
    if state0.loc.shape[-1] != n_logical:
        raise ValueError(f"ssd_step: the jobs of one launch share one "
                         f"logical space; {state0.loc.shape[-1]} != "
                         f"{n_logical}")
    if job.n_pad < 0:
        raise ValueError("ssd_step: n_pad must be >= 0")
    if job.n_pad and job.pad_t is None:
        raise ValueError("ssd_step: n_pad > 0 needs pad_t")
    plan = segs.get("src") is not None
    if plan != (segs.get("scat_lba") is not None):
        raise ValueError("ssd_step: give src and scat_lba together")
    if k > 1 and not plan:
        raise ValueError("ssd_step: K > 1 needs the hazard plan")
    if wear and (plan or k != 1 or job.n_pad):
        raise ValueError("ssd_step: a wear job is the per-op stream (K = 1, "
                         "no hazard plan) and steps every op (n_pad = 0)")
    if job.window_ops is not None and int(job.window_ops) <= 0:
        raise ValueError(f"ssd_step: window_ops must be positive, got "
                         f"{job.window_ops}")
    i32, f32 = torch.int32, torch.float32
    plane_int = (torch.int16, torch.int32)
    shp = (c_cnt, s_cnt, k)
    check("ssd_step", "arrival_ms", segs["arrival_ms"], f32, shp, dev)
    check("ssd_step", "lba", lba, i32, shp, dev)
    check("ssd_step", "is_write", segs["is_write"], i32, shp, dev)
    if plan:
        check("ssd_step", "src", segs["src"], i32, shp, dev)
        check("ssd_step", "scat_lba", segs["scat_lba"], i32, shp, dev)
    for name, dt in (("cap_basic", i32), ("cap_trad", i32),
                     ("cap_boost", i32), ("idle_thr", f32),
                     ("waste_p", f32)):
        check("ssd_step", name, getattr(params, name), dt, (c_cnt,), dev)
    pad_t = job.pad_t
    if pad_t is None:
        pad_t = torch.zeros(c_cnt, dtype=f32, device=dev)
    check("ssd_step", "pad_t", pad_t, f32, (c_cnt,), dev)
    for name, dt, shape in (
            ("busy", f32, (c_cnt, p)), ("slc_used", plane_int, (c_cnt, p)),
            ("rp_done", plane_int, (c_cnt, p)),
            ("trad_used", plane_int, (c_cnt, p)),
            ("valid_mig", plane_int, (c_cnt, p)),
            ("epoch", plane_int, (c_cnt, p)),
            ("loc", torch.int8, (c_cnt, n_logical)),
            ("loc_ep", torch.int16, (c_cnt, n_logical)),
            ("counters", f32, (c_cnt, len(CTR))), ("prev_t", f32, (c_cnt,)),
            ("idle_cum", f32, (c_cnt,)), ("idle_seen", f32, (c_cnt, p))):
        check("ssd_step", name, getattr(state0, name), dt, shape, dev)
    if wear:
        b = WEAR_BUCKETS
        for name in EnduranceParams._fields:
            check("ssd_step", name, getattr(params.endurance, name), f32,
                  (c_cnt,), dev)
        for name, shape in (("pe_slc", (c_cnt, p, b)),
                            ("pe_rp", (c_cnt, p, b)), ("pe_tlc", (c_cnt, p)),
                            ("erase", (c_cnt, p)), ("pe_trad", (c_cnt, p)),
                            ("erase_trad", (c_cnt, p)),
                            ("ops_seen", (c_cnt,)), ("eol_op", (c_cnt,))):
            check("ssd_step", name, getattr(state0.wear, name), f32, shape,
                  dev)
    return {"code": code, "C": c_cnt, "S": s_cnt, "K": k, "plan": plan,
            "pad_t": pad_t, "wear": wear}


def _probe_rows(job: StreamJob, x: dict, dev) -> Optional[ProbeRows]:
    """Empty outputs of a probe job's cells: head (C, S*K, 2), counter
    snapshots (C, W, N) and, with wear, peaks (C, W); None with the
    probe off."""
    if job.window_ops is None:
        return None
    n_ops = x["S"] * x["K"]
    w_cnt = probe.n_windows(n_ops + job.n_pad, int(job.window_ops))
    f32 = torch.float32
    return ProbeRows(
        head=torch.empty((x["C"], n_ops, 2), dtype=f32, device=dev),
        snap=torch.empty((x["C"], w_cnt, len(CTR)), dtype=f32, device=dev),
        wear_peak=(torch.empty((x["C"], w_cnt), dtype=f32, device=dev)
                   if x["wear"] else None))


def run_streams(cfg, jobs: Sequence[StreamJob], *, timer=None) -> list:
    """Run every job's cells in one launch; returns [(latency (C, S, K)
    f32, final SimState in the job's `state0` dtypes, its wear carry
    included, and for a probe job its `ProbeRows` in `timeline`)] in job
    order.

    On a CUDA device the cells run side by side, one block each, the
    longest stream (S x K) first. `timer`, if given, is a (cells, 6)
    int64 CUDA tensor over the jobs' cells in order; each block writes
    its `TIMER_COLUMNS` there: %globaltimer at its start and end (ns),
    the ops it scanned and the pads it replayed, and the recurrence
    thread's clock64 cycles in all and waiting on the op ring. The plain
    version (tensors on the CPU) leaves `timer` untouched."""
    jobs = list(jobs)
    if not jobs:
        return []
    devs = {j.segs["lba"].device for j in jobs}
    if len(devs) != 1:
        raise ValueError(f"ssd_step: the jobs lie on several devices: "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    for j in jobs:
        _SPECIALISATIONS.add((
            composition_code(resolve_spec(j.policy)), bool(j.closed_loop),
            j.segs["lba"].shape[-1] == 1, j.params.endurance is not None,
            j.window_ops is not None))
    if not kernel_route("ssd_step", jobs[0].segs["lba"]):
        return [ref.run_stream_ref(cfg, resolve_spec(j.policy), j.segs,
                                   j.state0, closed_loop=j.closed_loop,
                                   params=j.params, n_pad=j.n_pad,
                                   pad_t=j.pad_t, window_ops=j.window_ops)
                for j in jobs]
    refuse_grad("ssd_step", list(jobs))
    p = cfg.num_planes
    n_logical = jobs[0].state0.loc.shape[-1]
    if p > 128:
        raise ValueError(f"ssd_step: {p} planes; int8 residency holds at "
                         "most 128")
    if n_logical > MAX_PAGES:
        raise ValueError(f"ssd_step: {n_logical} logical pages; the op "
                         f"ring indexes at most {MAX_PAGES}")
    if block_smem_bytes(p, n_logical) > MAX_SMEM:
        raise ValueError(f"ssd_step: {n_logical} logical pages need "
                         f"{block_smem_bytes(p, n_logical)} B of shared "
                         f"memory, more than a block's {MAX_SMEM}")
    info = [_check_job(cfg, j, dev, n_logical) for j in jobs]
    if any(x["wear"] for x in info):
        if cfg.wear_buckets != WEAR_BUCKETS:
            raise ValueError(f"ssd_step: the kernel's wear rows hold "
                             f"{WEAR_BUCKETS} buckets, not "
                             f"{cfg.wear_buckets}")
        if not _wear_fits(p):
            raise ValueError(f"ssd_step: a wear cell's rows at {p} planes "
                             f"need {4 * (_wear_words(p) - 2)} B, more than "
                             f"the {WEAR_RING_FREE} B its ring frees")
    c_tot = sum(x["C"] for x in info)
    if timer is not None:
        check("ssd_step", "timer", timer, torch.int64,
              (c_tot, len(TIMER_COLUMNS)), dev)
    i32, f32 = torch.int32, torch.float32

    # the cells' carry and knobs, concatenated over the jobs; packed
    # int16 plane fields are widened to int32 at the boundary
    def cat(get):
        return torch.cat([get(j) for j in jobs]).contiguous()

    ins = {f: cat(lambda j, f=f: getattr(j.state0, f).to(i32)
                  if f in _WIDENED else getattr(j.state0, f))
           for f in _BASE_STATE}
    ins.update({f: cat(lambda j, f=f: getattr(j.params, f))
                for f in _BASE_PARAMS})
    ins["pad_t"] = torch.cat([x["pad_t"] for x in info]).contiguous()
    outs = {f"{f}_o": torch.empty_like(ins[f]) for f in _BASE_STATE}
    # the wear cells' knobs and packed state, in job order
    wear_jobs = [j for j, x in zip(jobs, info) if x["wear"]]
    if wear_jobs:
        ins["endur"] = torch.cat([
            torch.stack(list(j.params.endurance), dim=1)
            for j in wear_jobs]).contiguous()
        ins["wear"] = torch.cat([_pack_wear(j.state0.wear)
                                 for j in wear_jobs]).contiguous()
        outs["wear_o"] = torch.empty_like(ins["wear"])
    else:
        ins["endur"] = ins["wear"] = outs["wear_o"] = None
    lats = [torch.empty((x["C"], x["S"], x["K"]), dtype=f32, device=dev)
            for x in info]
    probes = [_probe_rows(j, x, dev) for j, x in zip(jobs, info)]

    # one descriptor a cell (pointers to its own stream: every per-op
    # array is 4 bytes an op), longest stream first
    rows, n_wear = [], 0
    for j, x, lat, pr in zip(jobs, info, lats, probes):
        n_ops = x["S"] * x["K"]
        streams = [j.segs["arrival_ms"], j.segs["lba"], j.segs["is_write"],
                   j.segs["src"] if x["plan"] else None,
                   j.segs["scat_lba"] if x["plan"] else None, lat]
        for c in range(x["C"]):
            wear_row = -1
            if x["wear"]:
                wear_row, n_wear = n_wear, n_wear + 1
            # the probe's outputs: this cell's rows of each (C, ...) tensor
            outs_c = [0, 0, 0]
            if pr is not None:
                outs_c = [t[c].data_ptr() if t is not None and t[c].numel()
                          else 0 for t in pr]
            rows.append([t.data_ptr() + 4 * c * n_ops
                         if t is not None and n_ops else 0 for t in streams]
                        + [x["code"], int(j.closed_loop), x["S"], x["K"],
                           int(j.n_pad), len(rows), wear_row,
                           int(j.window_ops or 0)] + outs_c)
    rows.sort(key=lambda r: -r[_DESC_ORDER.index("S")]
              * r[_DESC_ORDER.index("K")])
    desc_host = np.ascontiguousarray(np.array(rows, dtype=np.int64))
    desc = torch.from_numpy(desc_host).to(dev)
    ins["desc"] = desc
    table = [outs[n] if n.endswith("_o") else
             (timer if n == "timer" else ins[n]) for n in _PTR_ORDER]
    assert len(table) == len(_PTR_ORDER) and desc_host.shape[1] == len(
        _DESC_ORDER)
    ptrs = (ctypes.c_ulonglong * len(table))(
        *[0 if t is None else t.data_ptr() for t in table])
    dims = (ctypes.c_int * len(_DIM_ORDER))(c_tot, p, n_logical,
                                            cfg.pages_per_slc_block)
    consts = (ctypes.c_float * _N_FCONST)(*kernel_constants(cfg).tolist())
    LAUNCHER.launch("ssd_fleet_launch",
                    (ptrs, len(table), dims, len(_DIM_ORDER), consts,
                     _N_FCONST, desc_host.ctypes.data_as(
                         ctypes.POINTER(ctypes.c_longlong))), dev)

    results, lo, wlo = [], 0, 0
    for j, x, lat, pr in zip(jobs, info, lats, probes):
        hi = lo + x["C"]
        wear = None
        if x["wear"]:
            wear = _unpack_wear(outs["wear_o"][wlo:wlo + x["C"]], p)
            wlo += x["C"]
        final = SimState(*(outs[f"{f}_o"][lo:hi].to(
            getattr(j.state0, f).dtype) for f in _BASE_STATE), wear=wear,
            timeline=pr)
        results.append((lat, final))
        lo = hi
    return results


def run_stream(cfg, policy, segs, state0: SimState, *, closed_loop: bool,
               params, n_pad: int = 0, pad_t=None, window_ops=None):
    """Run one fleet's op streams and pad tails: `run_streams` with one
    job (the arguments of `StreamJob`). Returns (latency (C, S, K) f32,
    final SimState in `state0`'s dtypes)."""
    return run_streams(cfg, [StreamJob(policy, segs, state0, closed_loop,
                                       params, n_pad, pad_t, window_ops)])[0]


def smem_chase(steps: int, device="cuda") -> dict:
    """The latency of one dependent shared-memory load on the card: one
    thread chases a pointer ring in shared memory `steps` times (not a
    launch of the kernel: the count does not move). Returns cycles and
    ns per load, and the clock they imply."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("ssd_step: the shared-memory probe runs on the card")
    out = torch.zeros(4, dtype=torch.int64, device=dev)
    lib = LIB.load()
    with torch.cuda.device(dev):
        rc = lib.ssd_smem_chase(int(steps), out.data_ptr(),
                                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_step: smem chase failed with code {rc}")
    cycles, ns, n, _ = out.cpu().tolist()
    return {"steps": n, "cycles_per_load": cycles / n,
            "ns_per_load": ns / n, "clock_mhz": cycles / ns * 1e3}
