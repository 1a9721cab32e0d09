"""Wrapper of the `ssd_step` CUDA kernel (`csrc/ssd_step.cu`): build,
load, argument checks, launch, launch count and CUDA events.

`run_stream` runs a fleet's op streams — the per-op form (K = 1, no
hazard plan) or the (S, K) segment form — and each cell's pad-tail
replay. For tensors on a CUDA device it launches the kernel (one launch
for the whole fleet) or raises; tensors on the CPU go to the plain
version, `ref.run_stream_ref`. Nothing falls back.

The kernel is built at first use by `kernels._build` (nvcc into
`build/kernels/`, loaded with ctypes), with `-fmad=false`: the kernel
fuses exactly the reference's multiply-adds itself (ROADMAP §C).
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from repro_torch.core.ssd.policies.allocation import ALLOCATIONS
from repro_torch.core.ssd.policies.engine import (check_composition,
                                                  core_constants)
from repro_torch.core.ssd.policies.registry import resolve_spec
from repro_torch.core.ssd.policies.state import (CTR, OVERRUN_PAGES,
                                                 SimState)
from repro_torch.kernels._build import (BASE_FLAGS, LINK_FLAGS, Launcher,
                                        Library, check)
from repro_torch.kernels.ssd_step import ref

__all__ = ["run_stream", "reset", "launches", "events",
           "composition_code", "kernel_constants", "smem_bytes",
           "MAX_LANES", "SOURCE", "NVCC_FLAGS", "LIB", "LAUNCHER"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "ssd_step.cu")
NVCC_FLAGS = BASE_FLAGS + ("-fmad=false",) + LINK_FLAGS
MAX_LANES = 32
MAX_SMEM = 232448           # bytes of shared memory a block may use

# argument tables, in the order csrc/ssd_step.cu reads them
_PTR_ORDER = (
    "arrival_ms", "lba", "is_write", "src", "scat_lba",
    "cap_basic", "cap_trad", "cap_boost", "idle_thr", "waste_p", "pad_t",
    "busy", "slc_used", "rp_done", "trad_used", "valid_mig", "epoch",
    "counters", "prev_t", "idle_cum", "idle_seen", "loc", "loc_ep",
    "lat_o", "busy_o", "slc_used_o", "rp_done_o", "trad_used_o",
    "valid_mig_o", "epoch_o", "counters_o", "prev_t_o", "idle_cum_o",
    "idle_seen_o", "loc_o", "loc_ep_o")
_DIM_ORDER = ("comp", "closed", "C", "S", "K", "P", "N", "n_pad", "ppb")
_N_FCONST = 11


def composition_code(spec) -> int:
    """The kernel's template selector for a composition (the bits of
    csrc/ssd_step.cu: DUAL 1, ADAPTIVE 2, MIGRATE 4, PRESSURE 8, AGC 16)."""
    check_composition(spec)
    return ((1 if ALLOCATIONS[spec.allocation].dual else 0)
            | (2 if spec.allocation == "adaptive" else 0)
            | (4 if spec.mechanism == "migrate" else 0)
            | (8 if spec.trigger == "watermark" else 0)
            | (16 if spec.idle == "agc" else 0))


def kernel_constants(cfg) -> np.ndarray:
    """The float constants of the core, computed in Python doubles and
    rounded once to float32 — what the reference's weak-typed Python
    floats become where they meet a float32 value."""
    k = core_constants(cfg)
    t_ = cfg.timing
    return np.array([k["c_mig"], k["c_agc"], k["c_trad_rp"],
                     OVERRUN_PAGES * k["c_mig"], k["c_agc"] * 0.5,
                     k["erase_ms"], t_.slc_read_ms, t_.tlc_read_ms,
                     t_.slc_write_ms, t_.tlc_write_ms, t_.reprogram_ms],
                    dtype=np.float32)


def smem_bytes(n_planes: int, n_logical: int) -> int:
    """Dynamic shared memory one cell's block needs: the seven (P,)
    plane arrays, `loc_ep` int16 and `loc` int8."""
    return 7 * 4 * n_planes + 3 * n_logical


def _bind(lib) -> None:
    lib.ssd_stream_launch.argtypes = [
        ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_ulonglong]
    lib.ssd_stream_launch.restype = ctypes.c_int


LIB = Library("ssd_step", SOURCE, NVCC_FLAGS, _bind)
# every launch is bracketed by CUDA events: the sweep runner reads each
# group's kernel time from them
LAUNCHER = Launcher(LIB, "ssd_step")
LAUNCHER.record = True


def reset() -> None:
    """Zero the launch count and drop the recorded launch events."""
    LAUNCHER.reset()


def __getattr__(name):
    # `launches` (launches since the last reset(); the plain version and
    # argument errors never count) and `events` ((start, end) CUDA events
    # of each of those launches) are the launcher's
    if name in ("launches", "events"):
        return getattr(LAUNCHER, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def run_stream(cfg, policy, segs, state0: SimState, *, closed_loop: bool,
               params, n_pad: int = 0, pad_t=None):
    """Run C cells' op streams and pad tails.

    `segs`: (C, S, K) `arrival_ms` f32, `lba` i32, `is_write` i32, and
    for K > 1 the hazard plan `src`/`scat_lba` i32 (without it the
    stream is the per-op form, K = 1). `state0`: SimState with a leading
    cell axis, packed or unpacked. `params`: CellParams of (C,) tensors.
    `pad_t`: (C,) f32 arrival of each cell's `n_pad` identical tail pads.
    Returns (latency (C, S, K) f32, final SimState in `state0`'s
    dtypes)."""
    spec = resolve_spec(policy)
    lba = segs["lba"]
    if lba.device.type == "cpu":
        return ref.run_stream_ref(cfg, spec, segs, state0,
                                  closed_loop=closed_loop, params=params,
                                  n_pad=n_pad, pad_t=pad_t)
    if lba.device.type != "cuda":
        raise ValueError(f"ssd_step: no kernel for device {lba.device}")
    code = composition_code(spec)
    dev = lba.device
    if lba.dim() != 3:
        raise ValueError(f"ssd_step: segs must be (C, S, K), got "
                         f"{tuple(lba.shape)}")
    c_cnt, s_cnt, k = lba.shape
    p = cfg.num_planes
    n_logical = state0.loc.shape[-1]
    if not 1 <= k <= MAX_LANES:
        raise ValueError(f"ssd_step: K = {k} lanes; the kernel takes 1.."
                         f"{MAX_LANES}")
    if p > 128:
        raise ValueError(f"ssd_step: {p} planes; int8 residency holds at "
                         "most 128")
    if smem_bytes(p, n_logical) > MAX_SMEM:
        raise ValueError(f"ssd_step: {n_logical} logical pages need "
                         f"{smem_bytes(p, n_logical)} B of shared memory, "
                         f"more than a block's {MAX_SMEM}")
    if n_pad and pad_t is None:
        raise ValueError("ssd_step: n_pad > 0 needs pad_t")
    plan = segs.get("src") is not None
    if plan != (segs.get("scat_lba") is not None):
        raise ValueError("ssd_step: give src and scat_lba together")
    if k > 1 and not plan:
        raise ValueError("ssd_step: K > 1 needs the hazard plan")
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

    # packed int16 plane fields are widened to int32 at the boundary
    ins = {**segs, **params._asdict(), "pad_t": pad_t,
           **{f: getattr(state0, f).to(i32) if f in (
               "slc_used", "rp_done", "trad_used", "valid_mig", "epoch")
              else getattr(state0, f) for f in SimState._fields}}
    outs = {"lat_o": torch.empty(shp, dtype=f32, device=dev),
            **{f"{f}_o": torch.empty_like(ins[f]) for f in SimState._fields}}
    table = [outs[n] if n.endswith("_o") else ins.get(n)
             for n in _PTR_ORDER]
    ptrs = (ctypes.c_ulonglong * len(table))(
        *[0 if t is None else t.data_ptr() for t in table])
    dims = (ctypes.c_int * len(_DIM_ORDER))(
        code, int(closed_loop), c_cnt, s_cnt, k, p, n_logical, int(n_pad),
        cfg.pages_per_slc_block)
    consts = (ctypes.c_float * _N_FCONST)(*kernel_constants(cfg).tolist())
    LAUNCHER.launch("ssd_stream_launch",
                    (ptrs, len(table), dims, len(_DIM_ORDER), consts,
                     _N_FCONST), dev)
    final = SimState(*(outs[f"{f}_o"].to(getattr(state0, f).dtype)
                       for f in SimState._fields))
    return outs["lat_o"], final
