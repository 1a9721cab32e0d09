"""Wrapper of the `host_tier` CUDA kernel (`csrc/host_tier.cu`): build,
load, argument checks, launch, launch count and CUDA events.

`tier_pass(jobs)` runs every job's cells through the host tier in ONE
launch, one block a cell. A job (`ref.TierJob`) is one fleet of host
cells sharing a `HostCacheSpec` and a mode; jobs may differ in both. Each
cell's state crosses as one row of int32 words (`state_words`): its
(sets, ways) `tag`, `dirty`, `age`, its (sets,) `shadow_tag` and
`shadow_cnt`, then `tick`, `dirty_n`, `flushing`, `fcur`, `prev_t` and
the eight host counters (the floats by their bits). The kernel keeps a
cell's arrays in shared memory when they fit `SMEM_BUDGET`, else in its
own row of the output buffer in device memory. For tensors on a CUDA
device the wrapper launches the kernel or raises; tensors on the CPU go
to the plain version, `ref.tier_pass_ref`, job by job. Nothing falls
back.

`prepare` builds the launch's buffers (descriptors, knobs, state words,
outputs) for any device and `finish` reads the results back: the
wrapper's launch uses them, and so do the tests that run the kernel's
recurrence compiled for the CPU (`host_tier_run_host`).
"""
from __future__ import annotations

import ctypes
import os
from typing import Sequence

import numpy as np
import torch

from repro_torch.hostcache.model import H_CTR, HCState, lines_inv
from repro_torch.kernels._build import (BASE_FLAGS, LINK_FLAGS, Launcher,
                                        Library, check, kernel_route,
                                        refuse_grad)
from repro_torch.kernels.host_tier import ref
from repro_torch.kernels.host_tier.ref import TierJob, TierOut, n_slots

__all__ = ["tier_pass", "prepare", "finish", "state_words", "reset",
           "launches", "events", "SOURCE", "NVCC_FLAGS", "LIB", "LAUNCHER",
           "SMEM_BUDGET", "DESC_FIELDS", "N_KNOB", "PROBE_COLUMNS"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "host_tier.cu")
NVCC_FLAGS = BASE_FLAGS + ("-fmad=false",) + LINK_FLAGS
# shared memory a cell's arrays may take; a larger geometry works in its
# own row of the output buffer in device memory
SMEM_BUDGET = 96 * 1024
# csrc/host_tier.cu's descriptor columns, knob columns and codes
DESC_FIELDS = ("arrival_ms", "lba", "is_write", "sub_t", "sub_lba",
               "sub_kind", "absorbed", "rows", "state", "T", "sets", "ways",
               "flush_per_op", "mode", "promote", "flush", "closed", "smem",
               "knob_row")
N_KNOB = 6
# the probe form's columns (csrc/host_tier.cu, N_PROBE): clock64 cycles
# of the whole pass and of each part of an op, summed over the cell's ops
PROBE_COLUMNS = ("cycles", "wait", "scan", "promote", "flush", "store",
                 "ops", "unused")
_MODES = {"wb": 0, "wt": 1, "wa": 2}
_PROMOTES = {"always": 0, "nth": 1}
_FLUSHES = {"watermark": 0, "idle": 1}
_I32, _F32 = torch.int32, torch.float32
_SCALARS = ("tick", "dirty_n", "flushing", "fcur")


def state_words(sets: int, ways: int) -> int:
    """int32 words of one cell's state row."""
    return 3 * sets * ways + 2 * sets + len(_SCALARS) + 1 + len(H_CTR)


def _array_bytes(spec) -> int:
    return 4 * (3 * spec.sets * spec.ways + 2 * spec.sets)


def _bind(lib) -> None:
    p = ctypes.c_void_p
    lib.host_tier_launch.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int,
                                     p, p, ctypes.c_ulonglong]
    lib.host_tier_launch.restype = ctypes.c_int


LIB = Library("host_tier", SOURCE, NVCC_FLAGS, _bind)
LAUNCHER = Launcher(LIB, "host_tier")
LAUNCHER.record = True


def reset() -> None:
    """Zero the launch count and drop the recorded launch events."""
    LAUNCHER.reset()


def __getattr__(name):
    # `launches` and `events` are the launcher's (see ssd_step.ops)
    if name in ("launches", "events"):
        return getattr(LAUNCHER, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _pack_state(hc: HCState) -> torch.Tensor:
    """(C, state_words) int32 rows of a fleet's HCState."""
    c_cnt = hc.tick.shape[0]
    parts = [hc.tag, hc.dirty, hc.age, hc.shadow_tag, hc.shadow_cnt]
    parts = [x.reshape(c_cnt, -1).to(_I32) for x in parts]
    parts += [getattr(hc, f).reshape(c_cnt, 1).to(_I32) for f in _SCALARS]
    parts += [hc.prev_t.reshape(c_cnt, 1).contiguous().view(_I32),
              hc.hctr.contiguous().view(_I32)]
    return torch.cat(parts, dim=1)


def _unpack_state(words: torch.Tensor, spec, dev_lat_ms) -> HCState:
    c_cnt, s, w = words.shape[0], spec.sets, spec.ways
    sizes = (s * w, s * w, s * w, s, s, 1, 1, 1, 1, 1, len(H_CTR))
    p = torch.split(words, sizes, dim=1)
    return HCState(
        tag=p[0].reshape(c_cnt, s, w), dirty=p[1].reshape(c_cnt, s, w),
        age=p[2].reshape(c_cnt, s, w), shadow_tag=p[3].contiguous(),
        shadow_cnt=p[4].contiguous(), tick=p[5][:, 0], dirty_n=p[6][:, 0],
        flushing=p[7][:, 0], fcur=p[8][:, 0],
        prev_t=p[9].contiguous().view(_F32)[:, 0],
        hctr=p[10].contiguous().view(_F32), dev_lat_ms=dev_lat_ms)


def _check_job(job: TierJob, dev) -> None:
    c_cnt, t_len = job.ops["lba"].shape
    if c_cnt < 1:
        raise ValueError("host_tier: a job needs at least one cell")
    for name, dt in (("arrival_ms", _F32), ("lba", _I32), ("is_write", _I32)):
        check("host_tier", name, job.ops[name], dt, (c_cnt, t_len), dev)
    for name in job.params._fields:
        check("host_tier", name, getattr(job.params, name), _F32, (c_cnt,),
              dev)
    s, w = job.spec.sets, job.spec.ways
    for name, dt, shape in (
            ("tag", _I32, (c_cnt, s, w)), ("dirty", _I32, (c_cnt, s, w)),
            ("age", _I32, (c_cnt, s, w)), ("shadow_tag", _I32, (c_cnt, s)),
            ("shadow_cnt", _I32, (c_cnt, s)), ("tick", _I32, (c_cnt,)),
            ("dirty_n", _I32, (c_cnt,)), ("flushing", _I32, (c_cnt,)),
            ("fcur", _I32, (c_cnt,)), ("prev_t", _F32, (c_cnt,)),
            ("hctr", _F32, (c_cnt, len(H_CTR))),
            ("dev_lat_ms", _F32, (c_cnt,))):
        check("host_tier", name, getattr(job.hc0, name), dt, shape, dev)


def prepare(jobs: Sequence[TierJob], dev) -> dict:
    """The launch's buffers on `dev`: `desc` (cells, len(DESC_FIELDS))
    int64 on the host (numpy) and its copy on `dev`, `knobs` (cells,
    N_KNOB) f32, `state_in`/`state_out` int32 words, `smem_bytes`, and
    each job's empty outputs (`outs`)."""
    jobs = list(jobs)
    for j in jobs:
        _check_job(j, dev)
    state_in = torch.cat([_pack_state(j.hc0).reshape(-1)
                          for j in jobs]).contiguous()
    state_out = torch.empty_like(state_in)
    knobs = torch.cat([torch.stack(
        [j.params.promote_n, j.params.wm_hi, j.params.wm_lo,
         j.params.flush_gap_ms,
         torch.full_like(j.params.wm_hi, float(j.spec.lines)),
         torch.full_like(j.params.wm_hi, lines_inv(j.spec))], dim=1)
        for j in jobs]).contiguous()
    smem_bytes = max([_array_bytes(j.spec) for j in jobs
                      if _array_bytes(j.spec) <= SMEM_BUDGET], default=0)
    rows, outs, offset = [], [], 0
    for j in jobs:
        c_cnt, t_len = j.ops["lba"].shape
        k = n_slots(j.spec)
        out = TierOut(
            sub={"arrival_ms": torch.empty((c_cnt, t_len * k), dtype=_F32,
                                           device=dev),
                 "lba": torch.empty((c_cnt, t_len * k), dtype=_I32,
                                    device=dev),
                 "is_write": torch.empty((c_cnt, t_len * k), dtype=_I32,
                                         device=dev)},
            absorbed=torch.empty((c_cnt, t_len), dtype=torch.int8,
                                 device=dev),
            rows=(torch.empty((c_cnt, t_len, len(H_CTR) + 1), dtype=_F32,
                              device=dev) if j.rows else None),
            hc=None)
        outs.append(out)
        words = state_words(j.spec.sets, j.spec.ways)
        in_smem = int(_array_bytes(j.spec) <= SMEM_BUDGET)
        for c in range(c_cnt):
            def ptr(t):
                return t[c].data_ptr() if t is not None and t[c].numel() \
                    else 0
            rows.append([ptr(j.ops["arrival_ms"]), ptr(j.ops["lba"]),
                         ptr(j.ops["is_write"]), ptr(out.sub["arrival_ms"]),
                         ptr(out.sub["lba"]), ptr(out.sub["is_write"]),
                         ptr(out.absorbed), ptr(out.rows), offset, t_len,
                         j.spec.sets, j.spec.ways, j.spec.flush_per_op,
                         _MODES[j.spec.mode], _PROMOTES[j.spec.promote],
                         _FLUSHES[j.spec.flush], int(j.closed_loop),
                         in_smem, len(rows)])
            offset += words
    desc_host = np.ascontiguousarray(np.array(rows, dtype=np.int64))
    assert desc_host.shape[1] == len(DESC_FIELDS)
    return {"desc_host": desc_host,
            "desc": torch.from_numpy(desc_host).to(dev), "knobs": knobs,
            "state_in": state_in, "state_out": state_out,
            "smem_bytes": smem_bytes, "outs": outs, "jobs": jobs}


def finish(buf: dict) -> list:
    """Each job's `TierOut` from a run's buffers."""
    results, lo = [], 0
    for j, out in zip(buf["jobs"], buf["outs"]):
        c_cnt = j.ops["lba"].shape[0]
        words = state_words(j.spec.sets, j.spec.ways)
        hi = lo + c_cnt * words
        hc = _unpack_state(buf["state_out"][lo:hi].reshape(c_cnt, words),
                           j.spec, j.hc0.dev_lat_ms)
        results.append(out._replace(absorbed=out.absorbed.bool(), hc=hc))
        lo = hi
    return results


def _check_probe(probe, jobs, dev) -> None:
    """Raise unless `probe` is None or what the probe form writes: a
    contiguous (cells, N_PROBE) int64 tensor on the jobs' card device."""
    if probe is None:
        return
    cells = sum(j.ops["lba"].shape[0] for j in jobs)
    want = (cells, len(PROBE_COLUMNS))
    if dev.type != "cuda" or probe.device != dev:
        raise ValueError(f"host_tier: the probe form runs on the card: "
                         f"probe on {probe.device}, jobs on {dev}")
    if probe.dtype != torch.int64 or tuple(probe.shape) != want or (
            not probe.is_contiguous()):
        raise ValueError(f"host_tier: probe must be a contiguous {want} "
                         f"int64 tensor (a row a cell), not "
                         f"{tuple(probe.shape)} {probe.dtype}")


def tier_pass(jobs: Sequence[TierJob], probe=None) -> list:
    """Every job's traces through the host tier in one launch; returns
    [`ref.TierOut`] in job order. `probe`, a contiguous (cells,
    N_PROBE) int64 tensor on the jobs' card, one row a cell in job
    order, selects the kernel's probe form, which adds each cell's
    clock64 cycles by part of an op (`PROBE_COLUMNS`); it has no CPU
    form."""
    jobs = list(jobs)
    if not jobs:
        return []
    devs = {j.ops["lba"].device for j in jobs}
    if len(devs) != 1:
        raise ValueError(f"host_tier: the jobs lie on several devices: "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    _check_probe(probe, jobs, dev)
    if not kernel_route("host_tier", jobs[0].ops["lba"]):
        return [ref.tier_pass_ref(j) for j in jobs]
    refuse_grad("host_tier", list(jobs))
    buf = prepare(jobs, dev)
    LAUNCHER.launch("host_tier_launch", (
        buf["desc"].data_ptr(), buf["knobs"].data_ptr(),
        buf["state_in"].data_ptr(), buf["state_out"].data_ptr(),
        len(buf["desc_host"]), buf["smem_bytes"],
        buf["desc_host"].ctypes.data,
        None if probe is None else probe.data_ptr()), dev)
    return finish(buf)
