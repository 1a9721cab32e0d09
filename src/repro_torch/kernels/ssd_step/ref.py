"""Plain version of the `ssd_step` kernel: the engine's own executors in a
Python loop, one cell after another.

`run_segments_ref` has the contract of the reference package's
`kernels/ssd_step/ref.py::run_segments_ref` (one cell, no tail replay);
`run_stream_ref` is what the CUDA kernel computes for a whole fleet —
each cell's stream (with its wear carry, when the cell tracks
endurance), then its pad tail replayed to the fixed point. The wrapper
(`ops.run_streams`) takes this path for tensors on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.ssd.policies.engine import (_build_core, build_step,
                                                  build_segment_step,
                                                  reduced_of, with_reduced)
from repro_torch.core.ssd.policies.registry import resolve_spec
from repro_torch.core.ssd.policies.state import (CellParams, SimState,
                                                 map_state)

__all__ = ["run_segments_ref", "run_stream_ref"]


def _run_per_op(cfg, policy, segs, state0: SimState, *, closed_loop,
                params: CellParams):
    """The per-op form (K = 1) of one cell's stream through the per-op
    executor. Returns (latency (S, 1), final SimState, wear included);
    `state0` is left untouched."""
    s_cnt, k = segs["lba"].shape
    if k != 1:
        raise ValueError("a stream without a hazard plan is per-op "
                         f"(K = 1), got K = {k}")
    step = build_step(cfg, policy, closed_loop=closed_loop, params=params)
    state = with_reduced(reduced_of(state0), state0.loc.clone(),
                         state0.loc_ep.clone(), state0.wear)
    lat = []
    for t, lba, kind in zip(segs["arrival_ms"].reshape(-1).unbind(),
                            segs["lba"].reshape(-1).unbind(),
                            segs["is_write"].reshape(-1).unbind()):
        state, latency = step(state, {"arrival_ms": t, "lba": lba,
                                      "is_write": kind})
        lat.append(latency)
    lat = (torch.stack(lat) if lat
           else torch.zeros(0, dtype=torch.float32, device=state.loc.device))
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


def run_stream_ref(cfg, policy, segs, state0: SimState, *, closed_loop,
                   params: CellParams, n_pad: int = 0, pad_t=None):
    """The kernel's function on a fleet: `segs` (C, S, K), `state0` and
    `params` with a leading cell axis, `pad_t` (C,). Each cell runs its
    stream, then `n_pad` identical tail pads to their exact fixed point
    (cells that track wear take no pad tail: they step every op).
    Returns (latency (C, S, K), final SimState)."""
    from repro_torch.core.ssd.sim import replay_pads
    spec = resolve_spec(policy)
    if n_pad and params.endurance is not None:
        raise ValueError("cells that track wear step every op: no pad tail")
    lats, finals = [], []
    for c in range(segs["lba"].shape[0]):
        p_c = map_state(lambda x: x[c], params)
        st_c = map_state(lambda x: x[c], state0)
        seg_c = {key: v[c] for key, v in segs.items() if v is not None}
        if seg_c.get("src") is None:
            lat, fin = _run_per_op(cfg, spec, seg_c, st_c,
                                   closed_loop=closed_loop, params=p_c)
            red, loc, loc_ep = reduced_of(fin), fin.loc, fin.loc_ep
        else:
            lat, (red, loc, loc_ep) = run_segments_ref(
                cfg, spec, seg_c, st_c, closed_loop=closed_loop,
                params=p_c)
            fin = None
        if n_pad:
            core = _build_core(cfg, spec, closed_loop=closed_loop,
                               params=p_c)
            red = replay_pads(core, red, loc[0], loc_ep[0], pad_t[c], n_pad)
        lats.append(lat)
        finals.append(with_reduced(red, loc, loc_ep,
                                   None if fin is None else fin.wear))
    return (torch.stack(lats),
            map_state(lambda *leaves: torch.stack(leaves), *finals))
