"""Plain version of the `ssd_step` kernel: the engine's own executors in a
Python loop, one cell after another.

`run_segments_ref` has the contract of the reference package's
`kernels/ssd_step/ref.py::run_segments_ref` (one cell, no tail replay);
`run_stream_ref` is what the CUDA kernel computes for a whole fleet —
each cell's stream (with its wear carry, when the cell tracks
endurance), then its pad tail replayed to the fixed point, and with
`window_ops` the telemetry probe's `ProbeRows`. The wrapper
(`ops.run_streams`) takes this path for tensors on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.ssd.policies.engine import (_build_core, build_step,
                                                  build_segment_step,
                                                  reduced_of, with_reduced)
from repro_torch.core.ssd.policies.registry import resolve_spec
from repro_torch.core.ssd.policies.state import (CTR, CellParams, SimState,
                                                 map_state)
from repro_torch.telemetry import probe

__all__ = ["run_segments_ref", "run_stream_ref"]


def _run_per_op(cfg, policy, segs, state0: SimState, *, closed_loop,
                params: CellParams, window_ops=None):
    """The per-op form (K = 1) of one cell's stream through the per-op
    executor. Returns (latency (S, 1), final SimState, wear included);
    `state0` is left untouched. With `window_ops` the final state's
    `timeline` holds the probe's per-op rows: (head (S, 2|3): occ_pages,
    the clamped idle claim and, with wear, the plane's peak cycles;
    counters (S, C))."""
    s_cnt, k = segs["lba"].shape
    if k != 1:
        raise ValueError("a stream without a hazard plan is per-op "
                         f"(K = 1), got K = {k}")
    step = build_step(cfg, policy, closed_loop=closed_loop, params=params)
    dev = state0.loc.device
    state = with_reduced(
        reduced_of(state0), state0.loc.clone(), state0.loc_ep.clone(),
        state0.wear,
        None if window_ops is None else probe.init_timeline(window_ops,
                                                            device=dev))
    lat, heads, ctrs = [], [], []
    for t, lba, kind in zip(segs["arrival_ms"].reshape(-1).unbind(),
                            segs["lba"].reshape(-1).unbind(),
                            segs["is_write"].reshape(-1).unbind()):
        state, out = step(state, {"arrival_ms": t, "lba": lba,
                                  "is_write": kind})
        if window_ops is not None:
            out, (row, ctr) = out
            # the row's occupancy fraction is formed from occ_pages, which
            # the probe's carry holds: the kernel's rows keep occ_pages
            heads.append(torch.cat([state.timeline.occ_pages[None],
                                    row[probe.ROW_IDLE:]]))
            ctrs.append(ctr)
        lat.append(out)
    lat = (torch.stack(lat) if lat
           else torch.zeros(0, dtype=torch.float32, device=dev))
    if window_ops is not None:
        n_cols = 3 if state0.wear is not None else 2
        state = state._replace(timeline=(
            torch.stack(heads) if heads
            else torch.zeros((0, n_cols), device=dev),
            torch.stack(ctrs) if ctrs
            else torch.zeros((0, len(CTR)), device=dev)))
    return lat.reshape(s_cnt, k), state


def run_segments_ref(cfg, policy, segs, state0: SimState, *, closed_loop,
                     params: CellParams):
    """Scan one cell's (S, K) stream from `state0`. Without `src`/
    `scat_lba` in `segs` the stream is the per-op form (the per-op
    executor, K = 1). Returns (latency (S, K), (Reduced, loc, loc_ep));
    `state0` is left untouched."""
    if segs.get("src") is None:
        lat, state = _run_per_op(cfg, policy, segs, state0,
                                 closed_loop=closed_loop, params=params)
        return lat, (reduced_of(state), state.loc, state.loc_ep)
    k = segs["lba"].shape[1]
    loc, loc_ep = state0.loc.clone(), state0.loc_ep.clone()
    seg_step = build_segment_step(cfg, policy, closed_loop=closed_loop,
                                  params=params)
    carry = (reduced_of(state0), loc, loc_ep)
    lat = []
    for s in range(segs["lba"].shape[0]):
        carry, lat_k = seg_step(carry, {key: v[s] for key, v in segs.items()})
        lat.append(lat_k)
    lat = (torch.stack(lat) if lat
           else torch.zeros((0, k), dtype=torch.float32, device=loc.device))
    return lat, carry


def _probe_segments(cfg, policy, segs, state0: SimState, *, closed_loop,
                    params: CellParams):
    """The (S, K) form of one cell's stream with the probe: the segment
    executor's per-lane extras, occ_pages rebuilt as the reference
    rebuilds it (a prefix sum of integer-valued float32 deltas: exact in
    any order). Returns (latency (S, K), (Reduced, loc, loc_ep), (head
    (S*K, 2), counters after every op (S*K, C)))."""
    k = segs["lba"].shape[1]
    dev = state0.loc.device
    carry = (reduced_of(state0), state0.loc.clone(), state0.loc_ep.clone())
    seg_step = build_segment_step(cfg, policy, closed_loop=closed_loop,
                                  params=params, emit_probe=True)
    outs = []
    for s in range(segs["lba"].shape[0]):
        carry, out = seg_step(carry, {key: v[s] for key, v in segs.items()})
        outs.append(out)
    if not outs:
        return (torch.zeros((0, k), dtype=torch.float32, device=dev), carry,
                (torch.zeros((0, 2), device=dev),
                 torch.zeros((0, len(CTR)), device=dev)))
    lat, occ_d, idle_c, ctr = (torch.stack(x) for x in zip(*outs))
    head = torch.stack([torch.cumsum(occ_d.reshape(-1), 0),
                        torch.clamp_min(idle_c.reshape(-1), 0.0)], -1)
    return lat, carry, (head, ctr.reshape(-1, len(CTR)))


def run_stream_ref(cfg, policy, segs, state0: SimState, *, closed_loop,
                   params: CellParams, n_pad: int = 0, pad_t=None,
                   window_ops=None):
    """The kernel's function on a fleet: `segs` (C, S, K), `state0` and
    `params` with a leading cell axis, `pad_t` (C,). Each cell runs its
    stream, then `n_pad` identical tail pads to their exact fixed point
    (cells that track wear take no pad tail: they step every op).
    Returns (latency (C, S, K), final SimState). With `window_ops` the
    final state's `timeline` is the probe's `ProbeRows` over each cell's
    padded length S x K + n_pad: head columns per scanned op, counters
    (and, with wear, peak cycles) at every window boundary, the tail's
    from `sim.replay_pads_windowed`."""
    from repro_torch.core.ssd.sim import replay_pads, replay_pads_windowed
    spec = resolve_spec(policy)
    if n_pad and params.endurance is not None:
        raise ValueError("cells that track wear step every op: no pad tail")
    s_cnt, k = segs["lba"].shape[1:]
    t_scan = s_cnt * k
    t_len = t_scan + n_pad
    lats, finals, rows = [], [], []
    for c in range(segs["lba"].shape[0]):
        p_c = map_state(lambda x: x[c], params)
        st_c = map_state(lambda x: x[c], state0)
        seg_c = {key: v[c] for key, v in segs.items() if v is not None}
        wear = head_ctr = None
        if seg_c.get("src") is None:
            lat, fin = _run_per_op(cfg, spec, seg_c, st_c,
                                   closed_loop=closed_loop, params=p_c,
                                   window_ops=window_ops)
            red, loc, loc_ep = reduced_of(fin), fin.loc, fin.loc_ep
            wear, head_ctr = fin.wear, fin.timeline
        elif window_ops is None:
            lat, (red, loc, loc_ep) = run_segments_ref(
                cfg, spec, seg_c, st_c, closed_loop=closed_loop,
                params=p_c)
        else:
            lat, (red, loc, loc_ep), head_ctr = _probe_segments(
                cfg, spec, seg_c, st_c, closed_loop=closed_loop,
                params=p_c)
        core = (_build_core(cfg, spec, closed_loop=closed_loop, params=p_c)
                if n_pad else None)
        if window_ops is None:
            if n_pad:
                red = replay_pads(core, red, loc[0], loc_ep[0], pad_t[c],
                                  n_pad)
        else:
            head, ctr_rows = head_ctr
            w0, counts = probe.tail_windows(t_len, t_scan, window_ops)
            idx = torch.as_tensor(probe.bounds(t_len, window_ops)[:w0],
                                  dtype=torch.long, device=head.device)
            snap = ctr_rows.index_select(0, idx)
            if n_pad:
                red, tail = replay_pads_windowed(core, red, loc[0],
                                                 loc_ep[0], pad_t[c], counts)
                snap = torch.cat([snap, tail])
            rows.append(probe.ProbeRows(
                head=head[:, :2].contiguous(), snap=snap,
                wear_peak=(head[:, probe.ROW_WEAR].index_select(0, idx)
                           if wear is not None else None)))
        lats.append(lat)
        finals.append(with_reduced(red, loc, loc_ep, wear))
    final = map_state(lambda *leaves: torch.stack(leaves), *finals)
    if rows:
        final = final._replace(timeline=map_state(
            lambda *leaves: torch.stack(leaves), *rows))
    return torch.stack(lats), final
