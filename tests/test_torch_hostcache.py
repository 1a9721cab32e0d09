"""The port's host tier (`repro_torch.hostcache`, `kernels/host_tier`)
against the reference's (`repro.hostcache`), live JAX on the CPU.

Here: the spec, the grid and the report layer; the three float sites of
the reference's compiled tier step, each pinned on a crafted state that
tells the candidate orders apart (the device-visible latency sum, the
probe's idle claim, the dirty fraction); the off-path identity; a host
cell that tracks wear; the `host_tier` kernel's recurrence compiled for
the CPU against its plain version; the CLI's `--hostcache`. Every mode x
promote x flush in both access modes is held to live JAX in
`test_torch_hostcache_modes.py` (the composed step) and
`test_torch_hostcache_fleet.py` (the pass route of `run_fleets`).
"""
import ctypes
import dataclasses
import json
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (CFG_J, CFG_T, N_LOGICAL, assert_leaf_equal,
                             assert_state_equal, host_trace)

from repro.core.ssd import sim as jsim
from repro.core.ssd.endurance.spec import EnduranceSpec as JEnduranceSpec
from repro.hostcache import pipeline as jpipe
from repro.hostcache.model import as_hc_params as j_as_hc
from repro.hostcache.spec import HostCacheSpec as JSpec
from repro.sweep import grid as jgrid
from repro.sweep import report as jreport
from repro_torch.core.ssd import fleet as tfleet
from repro_torch.core.ssd import sim as tsim
from repro_torch.core.ssd.endurance.spec import EnduranceSpec
from repro_torch.core.ssd.policies.registry import resolve_spec
from repro_torch.core.ssd.policies.state import init_state, map_state
from repro_torch.hostcache import pipeline
from repro_torch.hostcache.model import (H_CTR, as_hc_params, dirty_frac,
                                         init_hc)
from repro_torch.hostcache.spec import HostCacheSpec
from repro_torch.kernels.host_tier import ops as host_tier
from repro_torch.kernels.host_tier import ref as tier_ref
from repro_torch.kernels.ssd_step import ops as ssd_step
from repro_torch.sweep import grid as tgrid
from repro_torch.sweep import report as treport
from repro_torch.telemetry import probe

REPO = Path(__file__).resolve().parents[1]
PAPER_POLICIES = ("baseline", "ips", "ips_agc", "coop")


def _one(x):
    return x[None]


# ---------------------------------------------------------------------------
# spec, grid, report
# ---------------------------------------------------------------------------

PARSE = ("", "mode=wt,sets=64,ways=4,wm_hi=0.9", "mode=wb,flush=idle",
         "promote=nth,promote_n=3,flush_per_op=4,flush_gap_ms=2,hit_ms=0.01",
         "mode=wa,sets=96,ways=8,wm_lo=0.25")


@pytest.mark.parametrize("text", PARSE)
def test_spec_parse_and_tag_match_reference(text):
    j, t = JSpec.parse(text), HostCacheSpec.parse(text)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.tag == t.tag and j.lines == t.lines


@pytest.mark.parametrize("text", ("mode=xx", "sets=0", "flush_per_op=128",
                                  "bogus=1", "sets=abc", "promote=often",
                                  "mode"))
def test_spec_refuses_what_the_reference_refuses(text):
    with pytest.raises(ValueError) as jerr:
        JSpec.parse(text)
    with pytest.raises(ValueError) as terr:
        HostCacheSpec.parse(text)
    assert str(jerr.value) == str(terr.value)


def test_hostcache_grid_matches_reference():
    j = jgrid.named_grid("hostcache")
    t = tgrid.named_grid("hostcache")
    assert [p.key for p in j] == [p.key for p in t]
    assert len(t) == 40 and sum(p.hostcache is None for p in t) == 8
    assert [p.baseline for p in j] == [p.baseline for p in t]


def test_report_tables_match_reference():
    """`hostcache_summary` and the headline geomeans (which skip host
    cells) on the reference's recorded grid results."""
    with open(REPO / "BENCH_sweep_hostcache.json") as f:
        rec = json.load(f)["results"]
    j_res = {p: rec[p.key] for p in jgrid.named_grid("hostcache")}
    t_res = {p: rec[p.key] for p in tgrid.named_grid("hostcache")}

    def keyed(d):
        return {"/".join(map(str, k)): v for k, v in d.items()}

    assert keyed(treport.hostcache_summary(t_res)) == keyed(
        jreport.hostcache_summary(j_res))
    assert keyed(treport.policy_geomeans(t_res)) == keyed(
        jreport.policy_geomeans(j_res))
    assert keyed(treport.policy_geomeans_ci(t_res)) == keyed(
        jreport.policy_geomeans_ci(j_res))


# ---------------------------------------------------------------------------
# crafted one-op states: the float sites of the compiled tier step
# ---------------------------------------------------------------------------

S, W = 8, 2


def _crafted(flush_per_op, *, dev_lat=0.0):
    """A host tier whose lines are all dirty (distinct device planes), the
    watermark latch armed: one write to an absent lba then inserts
    (absorbed: slot 0 a pad), evicts a dirty victim (slot 1) and flushes
    `flush_per_op` lines (slots 2..K-1). Returns the spec's knobs, the
    numpy fields to set on both packages' host tiers and an idle
    device's plane busy times."""
    spec = dict(mode="wb", flush="watermark", sets=S, ways=W,
                flush_per_op=flush_per_op)
    tags = np.array([[s + S * (1 + 2 * w + 4 * s) for w in range(W)]
                     for s in range(S)], np.int32)
    fields = {"tag": tags, "dirty": np.ones((S, W), np.int32),
              "age": np.arange(1, S * W + 1, dtype=np.int32).reshape(S, W),
              "tick": np.int32(S * W), "dirty_n": np.int32(S * W),
              "flushing": np.int32(1), "dev_lat_ms": np.float32(dev_lat)}
    return spec, fields, np.zeros(CFG_T.num_planes, np.float32)


def _ref_steps(policy, spec_kw, fields, busy, ops, timeline=64):
    """The reference's compiled tier step, scanned over `ops` from the
    crafted state: (latency, probe rows, host rows, final state)."""
    hc = JSpec(**spec_kw)
    p = jsim.default_params(CFG_J, policy)._replace(hostcache=j_as_hc(hc))
    st0 = jsim.init_state(CFG_J, N_LOGICAL, timeline=timeline, hostcache=hc)
    st0 = st0._replace(busy=jnp.asarray(busy), hostcache=st0.hostcache
                       ._replace(**{k: jnp.asarray(v)
                                    for k, v in fields.items()}))
    step = jpipe.build_tier_step(CFG_J, policy, hc, closed_loop=False,
                                 params=p)
    fin, (lat, rows, hrows) = jax.jit(
        lambda s, o: jax.lax.scan(step, s, o))(st0, jsim.as_ops(ops))
    return lat, rows, hrows, fin


def _port_state(spec, fields, busy):
    st = init_state(CFG_T, N_LOGICAL, timeline=64, hostcache=spec,
                    device="cpu")
    hc = st.hostcache._replace(**{k: torch.as_tensor(np.asarray(v))
                                  for k, v in fields.items()})
    return st._replace(busy=torch.from_numpy(busy), hostcache=hc)


def _port_steps(policy, spec, fields, busy, ops):
    """The port's composed step from the crafted state: (latency, probe
    rows, host rows, final state)."""
    p = tsim.default_params(CFG_T, policy, device="cpu")._replace(
        hostcache=as_hc_params(spec, "cpu"))
    step = pipeline.build_tier_step(CFG_T, policy, spec, closed_loop=False,
                                    params=p)
    state = _port_state(spec, fields, busy)
    lat, rows, hrows = [], [], []
    t_ops = tsim.as_ops(ops, "cpu")
    for i in range(len(ops["lba"])):
        state, (out, (row, _), hrow) = step(
            state, {k: v[i] for k, v in t_ops.items()})
        lat.append(out)
        rows.append(row)
        hrows.append(hrow)
    return (torch.stack(lat), torch.stack(rows), torch.stack(hrows), state)


def _port_pass(policy, spec, fields, busy, ops):
    """The pass route from the crafted state: the tier pass, its sub-op
    stream through `ssd_step.run_streams`, the assembly. Returns
    (latency, final SimState, per-slot latencies (T, K), per-slot idle
    column (T, K))."""
    p = tsim.default_params(CFG_T, policy, device="cpu")._replace(
        hostcache=as_hc_params(spec, "cpu"))
    params = map_state(_one, p)
    t_ops = {k: v[None] for k, v in tsim.as_ops(ops, "cpu").items()}
    hc0 = map_state(_one, _port_state(spec, fields, busy).hostcache)
    group = tfleet.FleetGroup(policy, t_ops, params, False, hostcache=spec)
    out, = host_tier.tier_pass([tier_ref.TierJob(spec, t_ops,
                                                 params.hostcache, hc0,
                                                 False, rows=True)])
    state0 = init_state(CFG_T, N_LOGICAL, n_cells=1, device="cpu")
    state0 = state0._replace(busy=torch.from_numpy(busy)[None])
    k = tier_ref.n_slots(spec)
    n_sub = out.sub["lba"].shape[1]
    job = ssd_step.StreamJob(
        resolve_spec(policy),
        {key: v.reshape(1, n_sub, 1) for key, v in out.sub.items()}, state0,
        False, params, 0, None, 64 * k)
    (lat, final), = ssd_step.run_streams(CFG_T, [job])
    head = final.timeline.head.reshape(-1, k, 2)
    latency, final = pipeline.assemble(CFG_T, group, out, lat, final,
                                       timeline_ops=64)
    return (latency[0], map_state(lambda x: x[0], final),
            lat.reshape(-1, k), head[..., probe.ROW_IDLE])


def _one_write(lba=S * 100, t=2.0):
    return {"arrival_ms": np.float32([t]), "lba": np.int32([lba]),
            "is_write": np.int32([1])}


# site: (device-visible latency start, the victim plane's busy time) —
# "total" makes the running total's rounding visible (slot sum first,
# then one add, vs adding slot by slot), "slots" the order within the K
# slots (left to right vs pairwise)
DEV_LAT_SITES = {"total": (16777218.0, None), "slots": (0.0, 16777220.0)}


@pytest.mark.parametrize("flush_per_op", (1, 2, 4), ids=lambda f: f"K{f + 2}")
@pytest.mark.parametrize("site", sorted(DEV_LAT_SITES))
def test_dev_lat_sums_slots_left_to_right_then_adds(site, flush_per_op):
    """`dev_lat_ms + sum(where(live_k, lat_k, 0))`: the compiled reference
    sums the K slots left to right, then adds the sum to the running
    total (found at K = 3, 4 and 6 on states whose latencies tell the
    orders apart); both port routes do the same."""
    dev_lat, busy = DEV_LAT_SITES[site]
    spec_kw, fields, bz = _crafted(flush_per_op, dev_lat=dev_lat)
    vic_plane = int(fields["tag"][0, 0]) % CFG_T.num_planes
    if busy is not None:
        bz[vic_plane] = np.float32(busy)
    ops = _one_write()
    j_lat, _, j_h, j_fin = _ref_steps("ips", spec_kw, fields, bz, ops)
    spec = HostCacheSpec(**spec_kw)
    t_lat, _, t_h, t_fin = _port_steps("ips", spec, fields, bz, ops)
    assert_leaf_equal(j_lat, t_lat, "latency")
    assert_leaf_equal(j_h, t_h, "host rows")
    assert_state_equal(j_fin._replace(timeline=None),
                       t_fin._replace(timeline=None), site)
    p_lat, p_fin, lat_k, _ = _port_pass("ips", spec, fields, bz, ops)
    assert_leaf_equal(j_lat, p_lat, "pass latency")
    assert_leaf_equal(j_fin.hostcache.dev_lat_ms, p_fin.hostcache.dev_lat_ms,
                      "pass dev_lat_ms")
    # the site tells the orders apart: what the others would give
    m = lat_k[0].numpy()
    want = np.float32(j_fin.hostcache.dev_lat_ms)
    fold = np.float32(dev_lat)
    for x in m:
        fold = np.float32(fold + x)
    pair = list(m)
    while len(pair) > 1:
        pair = [np.float32(pair[i] + (pair[i + 1] if i + 1 < len(pair)
                                      else np.float32(0)))
                for i in range(0, len(pair), 2)]
    pairwise = np.float32(np.float32(dev_lat) + pair[0])
    if site == "total":
        assert fold != want
    elif len(m) > 3:
        assert pairwise != want


def test_probe_takes_only_slot0_idle_claim():
    """The probe row's idle column is slot 0's claim only: a write-back
    and flushes after a long gap claim idle budget while slot 0 is a pad
    (an absorbed insert), and the reference drops their claims."""
    spec_kw, fields, bz = _crafted(2)
    ops = _one_write(t=50.0)
    _, j_rows, _, j_fin = _ref_steps("ips", spec_kw, fields, bz, ops)
    spec = HostCacheSpec(**spec_kw)
    _, t_rows, _, t_fin = _port_steps("ips", spec, fields, bz, ops)
    assert_leaf_equal(j_rows[0], t_rows, "probe rows")
    _, p_fin, _, idle_k = _port_pass("ips", spec, fields, bz, ops)
    assert float(j_rows[0][0, probe.ROW_IDLE]) == 0.0
    assert float(idle_k[0, 1:].sum()) > 0.0     # the claims dropped
    # the window over the one op: only slot 0's claim
    assert float(p_fin.timeline.idle_ms[0]) == 0.0


@pytest.mark.parametrize("geometry", ((96, 8), (100, 3), (24, 5)),
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_dirty_fraction_site(geometry):
    """The host row's dirty fraction divides by a constant of the spec;
    the compiled reference multiplies by float32(1 / lines) instead (the
    two differ at these geometries), and so does the port."""
    sets, ways = geometry
    kw = dict(mode="wb", flush="watermark", sets=sets, ways=ways)
    trace = host_trace("flush_burst", "daily", 512, n_pad=0)
    _, st = jsim.run_trace(CFG_J, "ips", trace, closed_loop=False,
                           n_logical=N_LOGICAL, hostcache=JSpec(**kw),
                           timeline_ops=1)
    want = np.asarray(st.hostcache.hwin.dirty_frac)
    spec = HostCacheSpec(**kw)
    p = as_hc_params(spec, "cpu")
    out = tier_ref.tier_pass_ref(tier_ref.TierJob(
        spec, {k: v[None] for k, v in tsim.as_ops(trace, "cpu").items()},
        map_state(_one, p), init_hc(spec, 1, device="cpu"), False,
        rows=True))
    got = out.rows[0, :, len(H_CTR)]
    assert_leaf_equal(want, got, "dirty fraction")
    n = torch.round(got * spec.lines).to(torch.int32)
    assert torch.equal(dirty_frac(n, spec), got)
    assert (n.to(torch.float32) / spec.lines != got).any(), \
        "the geometry does not tell division from the reciprocal"


# ---------------------------------------------------------------------------
# the off path, a wear cell, the kernel's recurrence on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", PAPER_POLICIES)
def test_off_path_identity(policy):
    """hostcache=None is the device-only run, bit for bit: the reference's
    leaves, no host carry; and a launch that also runs host cells leaves
    an off group exactly its solo run."""
    trace = host_trace("hm_0", "daily", 256)
    j_lat, j_st = jsim.run_trace(CFG_J, policy, trace, closed_loop=False,
                                 n_logical=N_LOGICAL, hostcache=None)
    t_lat, t_st = tsim.run_trace(CFG_T, policy, trace, closed_loop=False,
                                 n_logical=N_LOGICAL, hostcache=None,
                                 device="cpu")
    assert t_st.hostcache is None
    assert_leaf_equal(j_lat, t_lat, "latency")
    assert_state_equal(j_st, t_st, policy)
    assert tsim.default_params(CFG_T, policy, device="cpu").hostcache is None
    spec = HostCacheSpec(sets=8, ways=2)
    ops = tfleet.stack_ops([trace], device="cpu")
    p = map_state(_one, tsim.default_params(CFG_T, policy, device="cpu"))
    off = tfleet.FleetGroup(policy, ops, p, False)
    host = tfleet.FleetGroup(policy, ops, p._replace(
        hostcache=map_state(_one, as_hc_params(spec, "cpu"))), False,
        hostcache=spec)
    (lat_a, st_a), _ = tfleet.run_fleets(CFG_T, [off, host],
                                         n_logical=N_LOGICAL)
    (lat_b, st_b), = tfleet.run_fleets(CFG_T, [off], n_logical=N_LOGICAL)
    assert torch.equal(lat_a, lat_b) and st_a.hostcache is None
    for f in st_b._fields:
        a, b = getattr(st_a, f), getattr(st_b, f)
        assert (a is None and b is None) or torch.equal(a, b), f


@pytest.mark.parametrize("route", ("composed", "pass"))
def test_host_cell_with_wear_matches_reference(route):
    """A host cell that tracks wear (EnduranceSpec defaults): `ops_seen`
    counts the non-pad sub-ops, as the reference's core does inside the
    tier's scan, so `eol_op` and every wear leaf come out the same."""
    trace = host_trace("flush_burst", "daily", 384)
    kw = dict(mode="wb", flush="watermark", sets=8, ways=2)
    j_p = jsim.default_params(CFG_J, "ips", endurance=JEnduranceSpec())
    j_lat, j_st = jsim.run_trace(CFG_J, "ips", trace, closed_loop=False,
                                 n_logical=N_LOGICAL, params=j_p,
                                 hostcache=JSpec(**kw), timeline_ops=128)
    spec = HostCacheSpec(**kw)
    t_p = tsim.default_params(CFG_T, "ips", endurance=EnduranceSpec(),
                              device="cpu")
    if route == "composed":
        t_lat, t_st = tsim.run_trace(CFG_T, "ips", trace, closed_loop=False,
                                     n_logical=N_LOGICAL, params=t_p,
                                     hostcache=spec, timeline_ops=128,
                                     device="cpu")
    else:
        group = tfleet.FleetGroup(
            "ips", tfleet.stack_ops([trace], device="cpu"),
            map_state(_one, t_p._replace(
                hostcache=as_hc_params(spec, "cpu"))), False,
            hostcache=spec)
        (lat, st), = tfleet.run_fleets(CFG_T, [group], n_logical=N_LOGICAL,
                                       timeline_ops=128)
        t_lat, t_st = lat[0], map_state(lambda x: x[0], st)
    assert_leaf_equal(j_lat, t_lat, "latency")
    assert_state_equal(j_st, t_st, route)
    assert float(t_st.wear.ops_seen) < 4 * len(trace["lba"])


@pytest.mark.parametrize("route", ("composed", "pass"))
def test_probe_off_matches_reference(route):
    """With the probe off the host runs are the reference's too, on both
    routes: no timeline, no host windows, every other leaf and the
    latency equal (the cases with the probe on are in the modes and
    fleet files)."""
    trace = host_trace("hm_1", "daily", 320)
    j_lat, j_st = jsim.run_trace(
        CFG_J, "ips_agc", trace, closed_loop=False, n_logical=N_LOGICAL,
        hostcache=JSpec(mode="wb", flush="idle", sets=8, ways=2,
                        flush_gap_ms=0.5))
    spec = HostCacheSpec(mode="wb", flush="idle", sets=8, ways=2,
                         flush_gap_ms=0.5)
    if route == "composed":
        t_lat, t_st = tsim.run_trace(CFG_T, "ips_agc", trace,
                                     closed_loop=False, n_logical=N_LOGICAL,
                                     hostcache=spec, device="cpu")
    else:
        p = tsim.default_params(CFG_T, "ips_agc", device="cpu")._replace(
            hostcache=as_hc_params(spec, "cpu"))
        (lat, st), = tfleet.run_fleets(
            CFG_T, [tfleet.FleetGroup(
                "ips_agc", tfleet.stack_ops([trace], device="cpu"),
                map_state(_one, p), False, hostcache=spec)],
            n_logical=N_LOGICAL)
        t_lat, t_st = lat[0], map_state(lambda x: x[0], st)
    assert t_st.timeline is None and t_st.hostcache.hwin is None
    assert_leaf_equal(j_lat, t_lat, "latency")
    assert_state_equal(j_st, t_st, route)
    assert float(t_st.hostcache.hctr[H_CTR["flush_w"]]) > 0


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """`csrc/host_tier.cu` built for the CPU: its warp recurrence with the
    32 lanes emulated by loops (`host_tier_run_host`)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    lib = tmp_path_factory.mktemp("host_tier") / "libhost_tier_host.so"
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2",
                    "-ffp-contract=off", "-shared", "-fPIC", "-o", str(lib),
                    host_tier.SOURCE], check=True)
    out = ctypes.CDLL(str(lib))
    out.host_tier_run_host.restype = ctypes.c_int
    return out


def _run_host(lib, jobs):
    """The jobs through the host-compiled kernel, in one call; each job's
    `TierOut`."""
    buf = host_tier.prepare(jobs, torch.device("cpu"))
    rc = lib.host_tier_run_host(
        ctypes.c_void_p(buf["desc_host"].ctypes.data),
        ctypes.c_void_p(buf["knobs"].data_ptr()),
        ctypes.c_void_p(buf["state_in"].data_ptr()),
        ctypes.c_void_p(buf["state_out"].data_ptr()),
        len(buf["desc_host"]))
    assert rc == 0
    return host_tier.finish(buf)


def _assert_tier_equal(got, ref, label):
    for k in ref.sub:
        assert torch.equal(got.sub[k], ref.sub[k]), (label, k)
    assert torch.equal(got.absorbed, ref.absorbed), label
    assert torch.equal(got.rows, ref.rows), label
    assert_state_equal(ref.hc, got.hc, label)


def test_kernel_recurrence_compiled_for_the_host(host_lib):
    """`csrc/host_tier.cu`'s warp recurrence (`tier_warp`, host and device
    code, its lanes emulated) built for the CPU: every output equal to the
    plain version's, over every mode, promotion and flush scheduler, both
    access modes, in one call of many cells."""
    jobs = []
    for i, (mode, promote, flush) in enumerate(
            (m, p, f) for m in ("wb", "wt", "wa")
            for p in ("always", "nth") for f in ("watermark", "idle")):
        # the way counts the kernel specialises (2, 4, 8, 16) and one it
        # reads at run time (3)
        spec = HostCacheSpec(mode=mode, promote=promote, flush=flush,
                             sets=(8, 16, 12, 32, 24)[i % 5],
                             ways=(2, 4, 3, 8, 16)[i % 5],
                             flush_per_op=1 + i % 3, flush_gap_ms=0.5)
        for access in ("daily", "bursty"):
            traces = [host_trace(name, access, 300)
                      for name in ("flush_burst", "hm_1")]
            ops = tfleet.stack_ops(traces, device="cpu")
            p = map_state(lambda x: torch.stack([x, x]),
                          as_hc_params(spec, "cpu"))
            jobs.append(tier_ref.TierJob(spec, ops, p,
                                         init_hc(spec, 2, device="cpu"),
                                         access == "bursty", rows=True))
    want = [tier_ref.tier_pass_ref(j) for j in jobs]
    fired = np.zeros(len(H_CTR))
    for j, got, ref in zip(jobs, _run_host(host_lib, jobs), want):
        _assert_tier_equal(got, ref, j.spec.tag)
        fired += ref.hc.hctr.sum(0).numpy()
    # every counter moved somewhere: hits, absorption, flushes, evictions
    assert (fired > 0).all(), fired


# the warp form's geometries: the hostcache grid's four specs x both
# access modes (the pass the card runs), then way counts 2, 3 (the generic
# form), 4 and 16 with flush sets in one round and in two (16 x 3 and
# 8 x 5 lanes exceed the warp), the 1024 x 8 cell whose state the card
# keeps in device memory, and 8 ways from a tick near 2^26 (the one-round
# form's packed keys would overflow: the generic form takes the cell)
WARP_CASES = ([(f"grid-{sp.tag}-{access}", sp, access, 1200)
               for sp in dict.fromkeys(pt.hostcache
                                       for pt in tgrid.named_grid("hostcache")
                                       if pt.hostcache is not None)
               for access in ("daily", "bursty")]
              + [("ways2-f4", HostCacheSpec(sets=8, ways=2, flush_per_op=4),
                  "daily", 400),
                 ("ways3-idle", HostCacheSpec(sets=12, ways=3, flush="idle",
                                              flush_gap_ms=0.5), "daily",
                  400),
                 ("ways4-f1", HostCacheSpec(sets=8, ways=4, flush_per_op=1),
                  "bursty", 400),
                 ("ways16-f3", HostCacheSpec(sets=8, ways=16,
                                             flush_per_op=3), "daily", 400),
                 ("ways8-f5", HostCacheSpec(sets=16, ways=8,
                                            flush_per_op=5), "bursty", 400),
                 ("1024x8-f4", HostCacheSpec(sets=1024, ways=8,
                                             flush_per_op=4), "daily",
                  400),
                 ("ways8-tick2^26", HostCacheSpec(sets=16, ways=8), "daily",
                  400)])


@pytest.mark.parametrize("label,spec,access,n_ops", WARP_CASES,
                         ids=[c[0] for c in WARP_CASES])
def test_warp_form_compiled_for_the_host(host_lib, label, spec, access,
                                         n_ops):
    """The host-compiled warp form bit for bit against `ref.tier_pass_ref`
    (sub-op streams, absorbed flags, host rows, final state) at each of
    its geometries; the small ones flush."""
    names = ("flush_burst",) if label.startswith("grid") else (
        "flush_burst", "hm_1")
    ops = tfleet.stack_ops([host_trace(n, access, n_ops) for n in names],
                           device="cpu")
    c_cnt = len(names)
    hc0 = init_hc(spec, c_cnt, device="cpu")
    if label.endswith("tick2^26"):
        hc0 = hc0._replace(tick=torch.full_like(hc0.tick, (1 << 26) - 100))
    job = tier_ref.TierJob(
        spec, ops, map_state(lambda x: torch.stack([x] * c_cnt),
                             as_hc_params(spec, "cpu")),
        hc0, access == "bursty", rows=True)
    ref = tier_ref.tier_pass_ref(job)
    _assert_tier_equal(_run_host(host_lib, [job])[0], ref, label)
    if not label.startswith(("grid", "1024")):
        assert float(ref.hc.hctr.sum(0)[H_CTR["flush_w"]]) > 0, label


def test_tier_pass_probe_runs_on_the_card_only():
    """The probe form has no CPU form: a probe beside CPU jobs raises
    instead of being ignored."""
    spec = HostCacheSpec()
    trace = host_trace("hm_0", "daily", 64)
    job = tier_ref.TierJob(
        spec, {k: v[None] for k, v in tsim.as_ops(trace, "cpu").items()},
        map_state(_one, as_hc_params(spec, "cpu")),
        init_hc(spec, 1, device="cpu"), False, rows=True)
    probe = torch.zeros((1, len(host_tier.PROBE_COLUMNS)),
                        dtype=torch.int64)
    with pytest.raises(ValueError, match="probe form runs on the card"):
        host_tier.tier_pass([job], probe=probe)


def test_run_compressed_refuses_host_cache_params():
    from repro_torch.workloads import compress_ops
    trace = host_trace("hm_0", "daily", 64)
    p = tsim.default_params(CFG_T, "ips", device="cpu")._replace(
        hostcache=as_hc_params(HostCacheSpec(), "cpu"))
    with pytest.raises(ValueError, match="host-cache"):
        tsim.run_compressed(CFG_T, "ips", compress_ops(trace, quantum=64),
                            closed_loop=False, n_logical=N_LOGICAL, params=p,
                            device="cpu")


def test_cli_hostcache_flag_matches_reference(tmp_path):
    """`--hostcache mode=wb,flush=idle` on a custom grid: every cell's
    result equal to the reference CLI's (the mean latency to rtol 1e-6:
    the port sums it in float64), the host-tier table in the artifact."""
    from repro.sweep.cli import main as jmain
    from repro_torch.sweep.cli import main as tmain
    args = ["--traces", "hm_1", "--policies", "baseline,ips", "--modes",
            "daily", "--hostcache", "mode=wb,flush=idle,flush_gap_ms=0.5",
            "--max-ops", "160", "--no-history", "--no-trace-cache-disk",
            "--name", "hc"]
    assert jmain(args + ["--devices", "1", "--out-dir",
                         str(tmp_path / "j")]) == 0
    assert tmain(args + ["--device", "cpu", "--out-dir",
                         str(tmp_path / "t")]) == 0
    j = json.loads((tmp_path / "j" / "BENCH_hc.json").read_text())
    t = json.loads((tmp_path / "t" / "BENCH_torch_hc.json").read_text())
    assert set(t["results"]) == set(j["results"])
    assert all("&hc=wb:idle:g0.5" in k for k in t["results"])
    for key, want in j["results"].items():
        got = t["results"][key]
        assert set(got) == set(want), key
        for m, v in want.items():
            if m == "mean_write_latency_ms":
                assert got[m] == pytest.approx(v, rel=1e-6), (key, m)
            else:
                assert got[m] == v, (key, m)
    assert set(t["hostcache"]) == set(j["hostcache"])
