"""Fleet simulation: every cell of one (composition, mode) group — or of
many groups — in one launch; port of the reference package's
`core/ssd/fleet.py`.

A fleet is a stacked `(C, T)` op tensor with per-cell `CellParams`
((C,) tensors). On a CUDA device `run_fleets` runs any number of fleets
(`FleetGroup`s, which may differ in composition, mode, length and
packing) as one launch of the `ssd_step` kernel, one thread block per
cell; `run_fleet` is its one-group case. On the CPU the kernel's plain
version loops over the cells. Either way cell i equals `sim.run_trace`
on that cell with the same parameters, bit for bit.

Memory: each cell's carry is dominated by its residency maps (`loc`
int8 + `loc_ep` int16 over 2^16 logical pages, 192 KB), which the kernel
holds in shared memory for the whole run. A fleet whose cells track wear
(`CellParams.endurance`) carries a `WearState` too, and steps every
padded op: the reference's fleet takes no pad trim for it, since tail
reclamation keeps erasing into the wear state.

`timeline_ops` turns the telemetry probe on for every group of the
launch (the kernel's probe form): each group's final state then carries
its `telemetry.probe.WindowedTimeline`, stacked over C, the windows
tiling the group's padded length.

A group that carries a `HostCacheSpec` (`FleetGroup.hostcache`) puts the
host tier in front of its cells (`hostcache.pipeline`): every host group
of the call goes through the tier in ONE launch of the `host_tier`
kernel, then each cell's (T*K) device sub-op stream joins the other
groups' streams in the one `ssd_step` launch, as a per-op stream over
the whole padded trace (no pad trim, as the reference's tier runs). Its
final state carries `hostcache`, and with the probe its host windows.

Ranks: inside a `torch.distributed` group (`distributed.group`),
`shard_cells` gives each rank its contiguous slice of the cell axis —
the cells carry no cross-cell dependency, so each rank runs its slice in
its own launch — and `cell_quantum` is the multiple callers pad the cell
axis to (replaying the last cell) so that the slice divides. Outside a
group both are the one-rank case.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.ssd.policies.registry import resolve_spec
from repro_torch.core.ssd.policies.state import (CellParams, SimState,
                                                 init_state, map_state)
from repro_torch.core.ssd.sim import flush_cache, summarize
from repro_torch.distributed import group as dgroup
from repro_torch.distributed.sharding import flat_paths, tree_map_path
from repro_torch.kernels.ssd_step import ops as ssd_step
from repro_torch.telemetry import probe, spans
from repro_torch.workloads.compress import TRIM_QUANTUM

__all__ = ["FleetGroup", "stack_params", "stack_ops", "run_fleets",
           "run_fleet", "flush_fleet", "summarize_fleet", "shard_cells",
           "cell_quantum", "shard_skip_count"]

# cumulative count of shard_cells calls that left every rank the whole
# cell axis because it did not divide the group — a structured signal
# (with the `fleet.shard_skipped` span event) instead of a fleet that
# merely looks slow
_SHARD_SKIPS = 0


def shard_skip_count() -> int:
    """How many fleets ran unsharded this process (the cell axis did not
    divide the group's size). Nonzero means ranks repeated each other's
    work: pad the cell axis to a `cell_quantum()` multiple."""
    return _SHARD_SKIPS


def shard_cells(tree, group=None):
    """This rank's contiguous slice of the leading (cell) axis of every
    leaf (tensors or numpy arrays, in dicts and NamedTuples): rank r of
    n takes cells [r C/n, (r+1) C/n).

    No-op outside a group or on one rank. When C does not divide n every
    rank keeps the whole axis, and the skip is counted
    (`shard_skip_count`, span event `fleet.shard_skipped`); callers pad
    the cells instead when they care (sweep.runner, search.scenario)."""
    n_ranks = dgroup.world_size(group)
    leaves = list(flat_paths(tree).values())
    if n_ranks <= 1 or not leaves:
        return tree
    n_cells = leaves[0].shape[0]
    if n_cells % n_ranks != 0:
        global _SHARD_SKIPS
        _SHARD_SKIPS += 1
        spans.event("fleet.shard_skipped", "fleet", n_cells=n_cells,
                    n_devices=n_ranks, idle_devices=n_ranks - 1)
        return tree
    per = n_cells // n_ranks
    r = dgroup.rank(group)
    return tree_map_path(lambda _, leaf: leaf[r * per:(r + 1) * per], tree)


def cell_quantum() -> int:
    """Cell-axis padding quantum: the process group's size, so that
    `shard_cells` divides the axis. Callers pad to a multiple of this,
    replaying the last real cell, and drop the pad from results. (The
    reference lcm's it with a shape bucket that keeps XLA's compiled
    shapes stable; the port's launch compiles nothing per cell count.)"""
    return dgroup.world_size()


class FleetGroup(NamedTuple):
    """One (composition, mode) fleet: `ops` (C, T) op tensors from
    `stack_ops`, `params` (C,)-stacked CellParams on the same device;
    `packed` carries int16 plane fields (gate on
    `policies.state.can_pack`)."""
    policy: object
    ops: dict
    params: CellParams
    closed_loop: bool
    packed: bool = False
    hostcache: object = None    # a HostCacheSpec: the host tier in front


def stack_params(params: Sequence[CellParams]) -> CellParams:
    """Stack per-cell CellParams into one CellParams of (C,) tensors
    (the cells agree on whether they track wear)."""
    return map_state(lambda *xs: torch.stack(xs), *params)


def stack_ops(traces: Sequence[dict], device="cuda") -> dict:
    """Stack padded traces into (C, T) op tensors (all traces share one
    padded length; `sweep.runner` groups cells by it)."""
    lens = {len(t["arrival_ms"]) for t in traces}
    if len(lens) != 1:
        raise ValueError(f"traces must share a padded length, got {lens}")

    def stack(key, dtype):
        return torch.as_tensor(
            np.stack([np.asarray(t[key], dtype) for t in traces]),
            device=device)

    return {"arrival_ms": stack("arrival_ms", np.float32),
            "lba": stack("lba", np.int32),
            "is_write": stack("is_write", np.int32)}


def _trim_len(is_write: np.ndarray, quantum: int = TRIM_QUANTUM) -> int:
    """Shared scannable prefix of a stacked (C, T) fleet: the largest
    per-cell live count, rounded up to `quantum` (the reference's
    choice, kept so the scanned lengths match its records). Beyond it
    every cell holds only its identical tail pads."""
    live = is_write >= 0
    t_len = is_write.shape[1]
    any_live = live.any(axis=1)
    last = t_len - np.argmax(live[:, ::-1], axis=1)
    n_live = int(np.max(np.where(any_live, last, 0), initial=1))
    return min(-(-n_live // quantum) * quantum, t_len)


def run_fleets(cfg, groups: Sequence[FleetGroup], *, n_logical: int,
               trim_pads: bool = False, timer=None,
               timeline_ops: int | None = None) -> list:
    """Simulate several fleets in one launch; returns [(latency (C, T),
    final SimState with leading C)] in group order.

    `trim_pads` scans only each group's shared live prefix and replays
    each cell's identical pad tail to its exact fixed point inside the
    same launch; groups that track wear step every op regardless.
    `timer`: the kernel's optional (cells, 6) int64 block timers over the
    groups' cells in order (`ssd_step.run_streams`). `timeline_ops`
    attaches the probe to every group (the final states' `timeline`).
    Results are identical either way, and equal `run_fleet` group by
    group. Host-cache groups run the tier pass first (one launch for
    all of them), then their sub-op streams in the same `ssd_step`
    launch as every other group."""
    from repro_torch.hostcache import pipeline
    from repro_torch.kernels.host_tier import ops as host_tier
    host = [g for g in groups if g.hostcache is not None]
    tier_outs = dict(zip(map(id, host), host_tier.tier_pass(
        [pipeline.tier_job(g, rows=timeline_ops is not None)
         for g in host])))
    jobs, shapes = [], []
    for g in groups:
        n_cells, t_len = g.ops["lba"].shape
        device = g.ops["lba"].device
        endurance = g.params.endurance is not None
        if g.hostcache is not None:
            jobs.append(pipeline.stream_job(cfg, g, tier_outs[id(g)],
                                            n_logical, timeline_ops))
            shapes.append(None)
            continue
        t_scan = t_len
        if trim_pads and not endurance:
            t_scan = _trim_len(g.ops["is_write"].cpu().numpy())
        n_pad = t_len - t_scan
        segs = {k: v[:, :t_scan].reshape(n_cells, t_scan, 1).contiguous()
                for k, v in g.ops.items()}
        pad_t = (g.ops["arrival_ms"][:, t_scan].contiguous() if n_pad
                 else None)
        state0 = init_state(cfg, n_logical, packed=g.packed,
                            n_cells=n_cells, endurance=endurance,
                            device=device)
        jobs.append(ssd_step.StreamJob(resolve_spec(g.policy), segs, state0,
                                       g.closed_loop, g.params, n_pad,
                                       pad_t, timeline_ops))
        shapes.append((n_cells, t_scan, n_pad))
    out = []
    for g, (lat, final), shape in zip(
            groups, ssd_step.run_streams(cfg, jobs, timer=timer), shapes):
        if g.hostcache is not None:
            out.append(pipeline.assemble(cfg, g, tier_outs[id(g)], lat,
                                         final, timeline_ops))
            continue
        n_cells, t_scan, n_pad = shape
        latency = torch.nn.functional.pad(lat.reshape(n_cells, t_scan),
                                          (0, n_pad))
        if timeline_ops is not None:
            final = final._replace(timeline=probe.from_rows(
                final.timeline, latency, g.ops["is_write"],
                g.ops["arrival_ms"],
                cap_pages=probe.cap_pages(g.params, cfg.num_planes),
                window_ops=timeline_ops, t_len=t_scan + n_pad))
        out.append((latency, final))
    return out


def run_fleet(cfg, policy, ops: dict, params: CellParams, *,
              closed_loop: bool, n_logical: int, trim_pads: bool = False,
              packed: bool = False, timeline_ops: int | None = None,
              hostcache=None):
    """Simulate a whole (composition, mode) fleet: `run_fleets` with one
    group. Returns (latency (C, T), final SimState with leading C).
    `hostcache` (a `HostCacheSpec`) puts the host tier in front of every
    cell; `params.hostcache` then holds its (C,) knobs."""
    return run_fleets(cfg, [FleetGroup(policy, ops, params, closed_loop,
                                       packed, hostcache)],
                      n_logical=n_logical, trim_pads=trim_pads,
                      timeline_ops=timeline_ops)[0]


def flush_fleet(cfg, states: SimState, policy) -> SimState:
    """End-of-workload flush (`sim.flush_cache`) over the C axis."""
    return flush_cache(cfg, states, policy)


def summarize_fleet(latency, is_write, states: SimState, *,
                    params: CellParams | None = None, cfg=None) -> dict:
    """Per-cell summaries: dict of (C,) tensors (same keys as
    `sim.summarize`); pass the (C,)-stacked `params` and `cfg` for the
    lifetime metrics of fleets that track wear."""
    return summarize(latency, is_write, states, cell=params, cfg=cfg)
