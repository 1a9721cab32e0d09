"""Port vs reference: the simulator's telemetry — the probe, windowed
timelines, cliff detection, spans, the history ledger and the store.

The counterparts of the reference's tests/test_telemetry.py, class for
class, on the port, plus the port against live JAX: the same op arrays
(the reference's `build_ops`, truncated, with an `ir.pad_ops` tail so
that window boundaries fall among the replayed tail pads) go through the
reference's `run_trace` / `run_compressed` / `run_fleet(trim_pads=True)`
with `timeline_ops` and through the port's (on the CPU: the `ssd_step`
kernel's plain version). Every `WindowedTimeline` leaf — the three
float sums included, which follow the reference's compiled summation
order at window sizes that are multiples of 32 — must be equal, bit for
bit; probe on must leave every other leaf what it is with the probe off.
"""
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ssd import fleet as jfleet
from repro.core.ssd import sim as jsim
from repro.core.ssd.endurance.spec import EnduranceSpec as JEnduranceSpec
from repro.telemetry import probe as jprobe
from repro.telemetry import timeline as jtimeline
from repro.workloads.compress import compress_ops as j_compress
from repro_torch.core.ssd import fleet as tfleet
from repro_torch.core.ssd import sim as tsim
from repro_torch.core.ssd.endurance.spec import EnduranceSpec
from repro_torch.core.ssd.policies.state import SimState
from repro_torch.kernels.ssd_step import ops as ssd_step
from repro_torch.sweep import cli as tcli
from repro_torch.telemetry import (Tracer, active_tracer, cell_timeline,
                                   detect_cliff, event, percentile, series,
                                   span, timeline_to_numpy)
from repro_torch.telemetry import probe as tprobe
from repro_torch.workloads.compress import SEG_LANES
from repro_torch.workloads.compress import compress_ops as t_compress
from torch_port_util import (CFG_J, CFG_T, N_LOGICAL, assert_leaf_equal,
                             assert_state_equal, fixture_ops)

MAX_OPS = 320
N_PAD = 320
WINDOW = 64            # 10 windows, 5 of them in the replayed tail
POLICIES = ["baseline", "ips", "coop", "ips_agc"]


def _trace(name="hm_0", n_pad=N_PAD):
    return fixture_ops(name, max_ops=MAX_OPS, n_pad=n_pad)


def _state_but_timeline(st):
    return st._replace(timeline=None)


def _assert_timelines_equal(ref, got, label=""):
    """Port timeline == reference timeline, every field, value and
    dtype (an absent `wear_peak` absent on both)."""
    assert ref is not None and got is not None, label
    assert_state_equal(ref, got, f"{label}: timeline")


@pytest.fixture(scope="module", params=["bursty", "daily"])
def mode(request):
    return request.param


@pytest.fixture(scope="module")
def trace():
    return _trace()


class TestProbeBitIdentity:
    @pytest.mark.parametrize("policy", POLICIES)
    def test_off_vs_on_identical(self, trace, mode, policy):
        """Probe on == probe off on every leaf but the timeline, and the
        port's timeline == the reference's, window for window."""
        cl = mode == "bursty"
        lat0, st0 = tsim.run_trace(CFG_T, policy, trace, closed_loop=cl,
                                   n_logical=N_LOGICAL, device="cpu")
        lat1, st1 = tsim.run_trace(CFG_T, policy, trace, closed_loop=cl,
                                   n_logical=N_LOGICAL, timeline_ops=WINDOW,
                                   device="cpu")
        assert torch.equal(lat0, lat1)
        assert st0.timeline is None and st1.timeline is not None
        assert_state_equal(st0, _state_but_timeline(st1), "on vs off")
        _, j_st = jsim.run_trace(CFG_J, policy, trace, closed_loop=cl,
                                 n_logical=N_LOGICAL, timeline_ops=WINDOW)
        _assert_timelines_equal(j_st.timeline, st1.timeline,
                                f"{policy}/{mode}")


class TestWindowConservation:
    def test_counters_and_histogram_conserve(self, trace, mode):
        """Per-window counter deltas telescope exactly to the final
        counters; windowed op/write counts match the trace; the latency
        histogram holds one entry per write; windowed latency sums add
        up to the latency output."""
        lat, st = tsim.run_trace(CFG_T, "baseline", trace,
                                 closed_loop=(mode == "bursty"),
                                 n_logical=N_LOGICAL, timeline_ops=WINDOW,
                                 device="cpu")
        tl = timeline_to_numpy(st.timeline)
        is_w = np.asarray(trace["is_write"])
        assert np.array_equal(tl["ctr"].sum(axis=0).astype(np.float32),
                              st.counters.numpy())
        assert tl["ops"].sum() == (is_w >= 0).sum()
        assert tl["writes"].sum() == (is_w == 1).sum()
        assert tl["lat_hist"].sum() == (is_w == 1).sum()
        wlat = np.where(is_w == 1, lat.numpy(), 0.0)
        assert np.isclose(tl["lat_sum"].sum(), wlat.sum(), rtol=1e-5)

    def test_fleet_cells_match_single_cell(self, mode):
        """Every fleet cell's timeline == the single-cell run's, leaf for
        leaf (windowing is positional, so stacking is transparent)."""
        traces = [_trace(n) for n in ("hm_0", "hm_1")]
        params = tfleet.stack_params([tsim.default_params(
            CFG_T, "ips", device="cpu") for _ in traces])
        cl = mode == "bursty"
        lat_f, st_f = tfleet.run_fleet(
            CFG_T, "ips", tfleet.stack_ops(traces, device="cpu"), params,
            closed_loop=cl, n_logical=N_LOGICAL, timeline_ops=WINDOW)
        tl_np = timeline_to_numpy(st_f.timeline)
        for i, tr in enumerate(traces):
            lat_r, st_r = tsim.run_trace(CFG_T, "ips", tr, closed_loop=cl,
                                         n_logical=N_LOGICAL,
                                         timeline_ops=WINDOW, device="cpu")
            assert torch.equal(lat_f[i], lat_r)
            ref = timeline_to_numpy(st_r.timeline)
            cell = cell_timeline(tl_np, i)
            for k in ref:
                assert np.array_equal(cell[k], ref[k]), k

    def test_window_count_shape(self, trace):
        t_len = len(trace["lba"])
        _, st = tsim.run_trace(CFG_T, "baseline", trace, closed_loop=True,
                               n_logical=N_LOGICAL, timeline_ops=WINDOW,
                               device="cpu")
        assert st.timeline.ops.shape == (tprobe.n_windows(t_len, WINDOW),)
        assert st.timeline.lat_hist.shape[-1] == tprobe.N_LAT_BUCKETS


class TestSeries:
    def test_series_schema_and_percentiles(self, trace):
        _, st = tsim.run_trace(CFG_T, "baseline", trace, closed_loop=True,
                               n_logical=N_LOGICAL, timeline_ops=WINDOW,
                               device="cpu")
        tl = timeline_to_numpy(st.timeline)
        s = series(tl)
        for k in ("window_ops", "n_windows", "ops", "writes",
                  "lat_mean_ms", "lat_p50_ms", "lat_p99_ms", "occ_frac",
                  "free_frac", "waf", "idle_ms", "t_end_ms", "host_w",
                  "slc_w", "tlc_w", "rp_w", "mig_w", "erases", "cliff"):
            assert k in s, k
        assert s["n_windows"] == len(s["ops"]) > 0
        for p50, p99, mean in zip(s["lat_p50_ms"], s["lat_p99_ms"],
                                  s["lat_mean_ms"]):
            if mean is not None:
                assert p50 <= p99
        occ = [v for v in s["occ_frac"] if v is not None]
        assert occ and all(0.0 <= v <= 1.0 for v in occ)
        # the port's series is the reference's on the same accumulators
        assert s == jtimeline.series(tl)

    def test_percentile_recovers_point_mass(self):
        edges = tprobe.LAT_EDGES_MS
        assert np.array_equal(edges, jprobe.LAT_EDGES_MS)
        assert edges.dtype == np.float32
        hist = np.zeros((1, edges.size + 1))
        hist[0, 4] = 100.0                  # [edges[3], edges[4])
        for q in (0.1, 0.5, 0.99):
            v = percentile(hist, edges, q)[0]
            assert edges[3] <= v <= edges[4]
        assert np.isnan(percentile(np.zeros((1, hist.shape[1])), edges,
                                   0.5)[0])


class TestCliffDetection:
    def _series(self, steady, cliff_at, ratio, n=40, sustain_n=10):
        lat = np.full(n, steady)
        lat[cliff_at:cliff_at + sustain_n] = steady * ratio
        return lat, np.full(n, 100.0)

    def test_detects_sustained_jump(self):
        lat, w = self._series(0.6, 20, 3.0)
        c = detect_cliff(lat, w, window_ops=512)
        assert c["detected"] and c["window"] == 20
        assert c["ratio"] == pytest.approx(3.0, rel=0.05)
        assert c["time_to_cliff_ops"] == 20 * 512
        assert c == jtimeline.detect_cliff(lat, w, window_ops=512)

    def test_ignores_single_window_spike(self):
        lat, w = self._series(0.6, 20, 3.0, sustain_n=1)
        assert not detect_cliff(lat, w)["detected"]

    def test_flat_series_has_no_cliff(self):
        lat, w = self._series(0.6, 0, 1.0)
        c = detect_cliff(lat, w)
        assert not c["detected"]
        assert c["steady_lat_ms"] == pytest.approx(0.6)

    def test_early_cliff_does_not_inflate_steady(self):
        lat = np.full(40, 0.6)
        lat[2:8] = 2.4
        c = detect_cliff(lat, np.full(40, 100.0))
        assert c["detected"] and c["window"] == 2
        assert c["steady_lat_ms"] == pytest.approx(0.6)

    def test_recovery_slope_sign(self):
        lat = np.full(40, 0.6)
        lat[10:] = np.linspace(3.0, 1.3, 30) * 0.6
        t_end = np.arange(40, dtype=np.float64) * 7.5
        c = detect_cliff(lat, np.full(40, 100.0), t_end=t_end)
        assert c["detected"] and c["recovery_slope"] < 0
        assert c == jtimeline.detect_cliff(lat, np.full(40, 100.0),
                                           t_end=t_end)


class TestSpans:
    def test_span_nesting_and_totals(self):
        tr = Tracer()
        with tr.activate():
            assert active_tracer() is tr
            with span("outer", "test", k=1):
                with span("inner", "test"):
                    pass
            event("marker", "test", note="x")
        assert active_tracer() is None
        spans = tr.to_json()
        names = [s["name"] for s in spans]
        assert names == ["outer", "inner", "marker"]
        outer = spans[names.index("outer")]
        inner = spans[names.index("inner")]
        assert inner["depth"] == outer["depth"] + 1
        assert inner["parent"] == names.index("outer")
        assert inner["dur_s"] <= outer["dur_s"]
        assert tr.totals()["outer"]["count"] == 1

    def test_span_without_tracer_still_times(self):
        with span("orphan", "test") as rec:
            pass
        assert rec["dur_s"] >= 0.0
        assert event("nobody", "test") is None


class TestSegmentWindows:
    """The segment (K = 32) form's windows equal the per-op form's — and
    the reference's — bit for bit, the pad tail's boundaries included."""

    @pytest.mark.parametrize("policy", POLICIES)
    def test_segment_vs_per_op_bit_identical(self, trace, mode, policy):
        comp = t_compress(trace, quantum=64)
        assert comp.n_pad > 0
        cl = mode == "bursty"
        lat_r, st_r = tsim.run_trace(CFG_T, policy, trace, closed_loop=cl,
                                     n_logical=N_LOGICAL,
                                     timeline_ops=WINDOW, device="cpu")
        lat_c, st_c = tsim.run_compressed(CFG_T, policy, comp,
                                          closed_loop=cl,
                                          n_logical=N_LOGICAL,
                                          timeline_ops=WINDOW, device="cpu")
        assert torch.equal(lat_r, lat_c)
        assert_state_equal(st_r, st_c, f"{policy}/{mode}")
        s_r = series(timeline_to_numpy(st_r.timeline))
        s_c = series(timeline_to_numpy(st_c.timeline))
        assert s_c["cliff"] == s_r["cliff"]

    def test_segment_window_conservation(self, trace, mode):
        comp = t_compress(trace, quantum=64)
        _, st = tsim.run_compressed(CFG_T, "baseline", comp,
                                    closed_loop=(mode == "bursty"),
                                    n_logical=N_LOGICAL,
                                    timeline_ops=WINDOW, device="cpu")
        tl = timeline_to_numpy(st.timeline)
        is_w = np.asarray(trace["is_write"])
        assert np.array_equal(tl["ctr"].sum(axis=0).astype(np.float32),
                              st.counters.numpy())
        assert tl["ops"].sum() == (is_w >= 0).sum()
        assert tl["writes"].sum() == (is_w == 1).sum()
        assert tl["lat_hist"].sum() == (is_w == 1).sum()

    def test_window_must_align_with_segment_lanes(self, trace):
        comp = t_compress(trace, quantum=64)
        before = ssd_step.launches
        with pytest.raises(ValueError, match=f"% {SEG_LANES}"):
            tsim.run_compressed(CFG_T, "baseline", comp, closed_loop=True,
                                n_logical=N_LOGICAL,
                                timeline_ops=WINDOW + 1, device="cpu")
        with pytest.raises(ValueError, match=f"% {SEG_LANES}"):
            tprobe.windowed_segments(
                torch.zeros(32), torch.zeros(32), torch.zeros(1, 10), None,
                torch.zeros(32), torch.zeros(32, dtype=torch.int32),
                torch.zeros(32), window_ops=33, t_len=32, t_scan=32,
                seg_lanes=SEG_LANES)
        assert ssd_step.launches == before

    def test_fleet_trim_timeline_identity(self):
        """The trimmed fleet with the probe == the full per-op fleet, per
        cell and leaf for leaf; no lane alignment on this path (an odd
        window size)."""
        traces = [_trace(n) for n in ("hm_0", "hm_1")]
        ops = tfleet.stack_ops(traces, device="cpu")
        params = tfleet.stack_params([tsim.default_params(
            CFG_T, "ips", device="cpu") for _ in traces])
        win = 96
        lat_f, st_f = tfleet.run_fleet(CFG_T, "ips", ops, params,
                                       closed_loop=False,
                                       n_logical=N_LOGICAL,
                                       timeline_ops=win)
        lat_t, st_t = tfleet.run_fleet(CFG_T, "ips", ops, params,
                                       closed_loop=False,
                                       n_logical=N_LOGICAL,
                                       timeline_ops=win, trim_pads=True)
        assert torch.equal(lat_f, lat_t)
        assert_state_equal(st_f, st_t, "fleet")


def _j_fleet_trim(traces, policy, window):
    params = jfleet.stack_params([jsim.default_params(CFG_J, policy)
                                  for _ in traces])
    return jfleet.run_fleet(CFG_J, policy, jfleet.stack_ops(traces), params,
                            closed_loop=False, n_logical=N_LOGICAL,
                            timeline_ops=window, trim_pads=True)


class TestMatchesReference:
    """The port's `WindowedTimeline` against live JAX on each path, with
    boundaries among the replayed tail pads."""

    @pytest.mark.parametrize("path", ("run_trace", "run_compressed",
                                      "fleet_trim"))
    def test_timeline_matches_reference(self, path):
        trace = _trace("proj_0")
        if path == "run_trace":
            _, j_st = jsim.run_trace(CFG_J, "ips_agc", trace,
                                     closed_loop=False, n_logical=N_LOGICAL,
                                     timeline_ops=128)
            _, t_st = tsim.run_trace(CFG_T, "ips_agc", trace,
                                     closed_loop=False, n_logical=N_LOGICAL,
                                     timeline_ops=128, device="cpu")
        elif path == "run_compressed":
            _, j_st = jsim.run_compressed(CFG_J, "coop", j_compress(trace, quantum=64),
                                          closed_loop=False,
                                          n_logical=N_LOGICAL,
                                          timeline_ops=128)
            _, t_st = tsim.run_compressed(CFG_T, "coop", t_compress(trace, quantum=64),
                                          closed_loop=False,
                                          n_logical=N_LOGICAL,
                                          timeline_ops=128, device="cpu")
        else:
            traces = [trace, _trace("hm_0")]
            _, j_st = _j_fleet_trim(traces, "baseline", 96)
            params = tfleet.stack_params([tsim.default_params(
                CFG_T, "baseline", device="cpu") for _ in traces])
            _, t_st = tfleet.run_fleet(
                CFG_T, "baseline", tfleet.stack_ops(traces, device="cpu"),
                params, closed_loop=False, n_logical=N_LOGICAL,
                timeline_ops=96, trim_pads=True)
        w0, counts = tprobe.tail_windows(len(trace["lba"]), MAX_OPS,
                                         int(t_st.timeline.window_ops
                                             .reshape(-1)[0]))
        assert counts, "no window boundary among the tail pads"
        assert_state_equal(j_st, t_st, path)

    def test_wear_cell_peak(self):
        """A wear cell (every op stepped, no tail): `wear_peak` — the
        serviced plane's peak cycles at each boundary — and every other
        window leaf equal the reference's."""
        knobs = dict(w_rp=4.0, w_erase=1.0, cycle_budget=3.0,
                     rp_budget=0.75, read_penalty_ms=0.05,
                     rp_hysteresis=0.25)
        trace = fixture_ops("proj_0", max_ops=384, n_pad=0)
        j_p = jsim.default_params(CFG_J, "ips_raro", 0.05,
                                  endurance=JEnduranceSpec(**knobs))
        j_p = j_p._replace(cap_basic=jnp.int32(16), cap_trad=jnp.int32(16))
        t_p = tsim.default_params(CFG_T, "ips_raro", 0.05,
                                  EnduranceSpec(**knobs), device="cpu")
        t_p = t_p._replace(cap_basic=torch.tensor(16, dtype=torch.int32),
                           cap_trad=torch.tensor(16, dtype=torch.int32))
        _, j_st = jsim.run_trace(CFG_J, "ips_raro", trace, closed_loop=False,
                                 n_logical=N_LOGICAL, params=j_p,
                                 timeline_ops=64)
        _, t_st = tsim.run_trace(CFG_T, "ips_raro", trace, closed_loop=False,
                                 n_logical=N_LOGICAL, params=t_p,
                                 timeline_ops=64, device="cpu")
        assert t_st.timeline.wear_peak is not None
        assert len(set(t_st.timeline.wear_peak.tolist())) > 1
        assert_state_equal(j_st, t_st, "wear")


# ---------------------------------------------------------------------------
# the summation order of the three float window sums
# ---------------------------------------------------------------------------

def _spread(rng, n):
    """float32 values over nine decades: sums in different orders round
    differently."""
    return (rng.random(n) * 10.0 ** rng.integers(-3, 6, n)).astype(
        np.float32)


@pytest.mark.parametrize("wo", (64, 96, 128, 480, 1024, 2048))
def test_window_sums_follow_the_reference_order(wo):
    """`probe.window_sum` is the reference's compiled `jnp.pad(x)
    .reshape(W, wo).sum(axis=1)` bit for bit (runs of 32 summed left to
    right, level by level), on inputs where left-to-right and pairwise
    sums differ from it; the last window partial."""
    rng = np.random.default_rng(wo)
    t_len = 6 * wo - 5
    occ, idle, lat = (_spread(rng, t_len) for _ in range(3))
    is_write = rng.integers(-1, 2, t_len).astype(np.int32)
    arrival = np.cumsum(rng.random(t_len)).astype(np.float32)
    ctr = np.cumsum(rng.random((t_len, 10)), 0).astype(np.float32)
    head = np.stack([occ, idle], 1)
    j_tl = jax.jit(lambda h, c, l, w, a: jprobe.windowed(
        (h, c), l, w, a, window_ops=wo, t_len=t_len))(
        head, ctr, lat, is_write, arrival)
    t_tl = tprobe.windowed(
        (torch.from_numpy(head), torch.from_numpy(ctr)),
        torch.from_numpy(lat), torch.from_numpy(is_write),
        torch.from_numpy(arrival), window_ops=wo, t_len=t_len)
    for field in j_tl._fields:
        assert_leaf_equal(getattr(j_tl, field), getattr(t_tl, field), field)
    # the pin tells orders apart: neither a left-to-right nor a
    # pairwise (numpy) sum is the reference's on these inputs
    x = np.pad(occ, (0, 6 * wo - t_len)).reshape(6, wo)
    seq = np.zeros(6, np.float32)
    for j in range(wo):
        seq = (seq + x[:, j]).astype(np.float32)
    ref = np.asarray(j_tl.occ_sum)
    assert not np.array_equal(seq, ref)
    assert not np.array_equal(x.sum(axis=1, dtype=np.float32), ref)


@pytest.mark.parametrize("fn", ("windowed_prefix", "windowed_segments"))
def test_prefix_and_segment_assembly_match_reference(fn):
    """The reference's two other assemblies on the same rows — a scanned
    prefix's per-op rows (or per-segment counters) and the replayed
    tail's snapshots — give the same windows in the port, bit for bit."""
    rng = np.random.default_rng(7)
    wo, t_scan, n_pad, lanes = 96, 384, 500, 32
    t_len = t_scan + n_pad
    w0, counts = jprobe.tail_windows(t_len, t_scan, wo)
    assert tprobe.tail_windows(t_len, t_scan, wo) == (w0, counts)
    occ, idle = _spread(rng, t_scan), _spread(rng, t_scan)
    ctr = np.cumsum(rng.random((t_scan, 10)), 0).astype(np.float32)
    tail = ctr[-1] + np.cumsum(rng.random((len(counts), 10)), 0).astype(
        np.float32)
    lat = np.concatenate([_spread(rng, t_scan), np.zeros(n_pad, np.float32)])
    is_write = np.concatenate([rng.integers(-1, 2, t_scan),
                               np.full(n_pad, -1)]).astype(np.int32)
    arrival = np.cumsum(rng.random(t_len)).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in (
        ("occ", occ), ("idle", idle), ("ctr", ctr), ("tail", tail),
        ("lat", lat), ("is_write", is_write), ("arrival", arrival))}
    if fn == "windowed_prefix":
        head = np.stack([occ, idle], 1)
        j_tl = jprobe.windowed_prefix(
            head, ctr, tail, lat, is_write, arrival, window_ops=wo,
            t_len=t_len, t_scan=t_scan)
        t_tl = tprobe.windowed_prefix(
            torch.from_numpy(head), t["ctr"], t["tail"], t["lat"],
            t["is_write"], t["arrival"], window_ops=wo, t_len=t_len,
            t_scan=t_scan)
    else:
        seg_ctr = ctr[lanes - 1::lanes]
        j_tl = jprobe.windowed_segments(
            occ, idle, seg_ctr, tail, lat, is_write, arrival,
            window_ops=wo, t_len=t_len, t_scan=t_scan, seg_lanes=lanes)
        t_tl = tprobe.windowed_segments(
            t["occ"], t["idle"], torch.from_numpy(seg_ctr), t["tail"],
            t["lat"], t["is_write"], t["arrival"], window_ops=wo,
            t_len=t_len, t_scan=t_scan, seg_lanes=lanes)
    for field in j_tl._fields:
        assert_leaf_equal(getattr(j_tl, field), getattr(t_tl, field), field)


def test_state_field_order_guard():
    """`wear`, `timeline` and `hostcache` trail the carry's base fields,
    in the reference's order; the kernel wrapper names its base fields
    rather than slicing `SimState._fields` (a new trailing field must
    never land in its argument table)."""
    from repro.core.ssd.policies.state import SimState as JSimState
    assert SimState._fields[-3:] == ("wear", "timeline", "hostcache")
    assert SimState._fields == JSimState._fields
    assert ssd_step._BASE_STATE == SimState._fields[:-3]
    from repro_torch import interop
    assert interop._BASE_STATE == ssd_step._BASE_STATE


# ---------------------------------------------------------------------------
# the history ledger, the store, and the CLI's telemetry flags
# ---------------------------------------------------------------------------

class TestHistory:
    """`BENCH_torch_history.json`: stdlib-only, atomic, git-SHA-keyed."""

    def _rec(self, tmp_path, ops, gm=1.0, config="ci:quick"):
        from repro_torch.telemetry import history
        return history.append_record(
            "sweep", config, directory=str(tmp_path), ops_per_s=ops,
            geomeans={"daily/ips/wa_paper": gm}, compiles=3,
            shard_skipped=0, git_sha="deadbeef")

    def test_append_load_roundtrip(self, tmp_path):
        from repro_torch.telemetry import history
        rec = self._rec(tmp_path, 1000.0)
        assert rec["git_sha"] == "deadbeef" and rec["kind"] == "sweep"
        assert os.path.isfile(tmp_path / "BENCH_torch_history.json")
        assert not os.path.exists(tmp_path / "BENCH_history.json")
        doc = history.load_history(str(tmp_path))
        assert doc["schema_version"] == 1
        assert [r["ops_per_s"] for r in doc["records"]] == [1000.0]
        self._rec(tmp_path, 1100.0)
        doc = history.load_history(str(tmp_path))
        assert len(doc["records"]) == 2
        assert doc["records"][0]["ops_per_s"] == 1000.0

    def test_concurrent_appends_lose_nothing(self, tmp_path):
        from repro_torch.telemetry import history
        errs = []

        def add(n):
            try:
                history.append_record("bench_step", "c", ops_per_s=n,
                                      directory=str(tmp_path), git_sha="x")
            except Exception as e:      # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=add, args=(float(n),))
                   for n in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs
        recs = history.load_history(str(tmp_path))["records"]
        assert sorted(r["ops_per_s"] for r in recs) == \
            [float(n) for n in range(8)]
        assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []

    def test_injected_2x_slowdown_caught(self, tmp_path):
        from repro_torch.telemetry import history
        for _ in range(3):
            self._rec(tmp_path, 1000.0)
        recs = history.load_history(str(tmp_path))["records"]
        assert history.check_regression(recs) == []
        self._rec(tmp_path, 500.0)
        recs = history.load_history(str(tmp_path))["records"]
        failures = history.check_regression(recs)
        assert len(failures) == 1 and "throughput" in failures[0]
        history.append_record("sweep", "tp", directory=str(tmp_path),
                              ops_per_s=1000.0, git_sha="x")
        history.append_record("sweep", "tp", directory=str(tmp_path),
                              ops_per_s=900.0, git_sha="x")
        recs = [r for r in history.load_history(str(tmp_path))["records"]
                if r["config"] == "tp"]
        assert history.check_regression(recs) == []

    def test_any_geomean_drift_fails(self, tmp_path):
        from repro_torch.telemetry import history
        self._rec(tmp_path, 1000.0, gm=0.53)
        self._rec(tmp_path, 1000.0, gm=0.530001)
        recs = history.load_history(str(tmp_path))["records"]
        failures = history.check_regression(recs)
        assert len(failures) == 1 and "drifted" in failures[0]

    def test_series_isolation_and_first_run(self, tmp_path):
        from repro_torch.telemetry import history
        self._rec(tmp_path, 1000.0, config="grid_a")
        self._rec(tmp_path, 100.0, config="grid_b")
        recs = history.load_history(str(tmp_path))["records"]
        assert history.check_regression(recs) == []

    def test_cli_check_exit_codes(self, tmp_path, capsys):
        from repro_torch.telemetry.history import _main
        assert _main(["--path", str(tmp_path), "--check"]) == 0
        for _ in range(2):
            self._rec(tmp_path, 1000.0)
        assert _main(["--path", str(tmp_path), "--check"]) == 0
        self._rec(tmp_path, 400.0)
        assert _main(["--path", str(tmp_path), "--check"]) == 1
        assert "REGRESSION" in capsys.readouterr().out


class TestStoreAtomicity:
    def test_save_bench_atomic_and_concurrent(self, tmp_path):
        """Concurrent writers to one artifact: the survivor is a complete
        document named `BENCH_torch_*`, and no temp files remain."""
        from repro_torch.sweep.store import (list_benches, load_bench,
                                             save_bench)
        payload = {"results": {f"k{i}": {"v": i} for i in range(200)}}
        errs = []

        def write(n):
            try:
                save_bench("atomic", {**payload, "writer": n},
                           directory=str(tmp_path))
            except Exception as e:      # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=write, args=(n,))
                   for n in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs
        assert sorted(os.listdir(tmp_path)) == ["BENCH_torch_atomic.json"]
        doc = load_bench(str(tmp_path / "BENCH_torch_atomic.json"))
        assert doc["writer"] in range(8)
        assert len(doc["results"]) == 200
        assert doc["meta"]["schema_version"] >= 1
        assert "git_sha" in doc["meta"] and "torch_version" in doc["meta"]
        (tmp_path / "BENCH_sweep_paper.json").write_text("{}")
        assert list(list_benches(str(tmp_path))) == ["torch_atomic"]


def test_cli_timeline_history_and_chrome_trace(tmp_path, capsys,
                                               monkeypatch):
    """`--timeline` writes `BENCH_torch_timeline.json` (windows and
    cliffs per cell) and a `BENCH_torch_history.json` record beside the
    sweep's artifact, never a reference name; `--chrome-trace` the span
    tree; `--history-check` passes on a steady history and exits 1 on an
    injected regression."""
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE_DIR", str(tmp_path / "tc"))
    out = tmp_path / "out"
    argv = ["--traces", "hm_0", "--policies", "baseline,ips", "--modes",
            "daily", "--device", "cpu", "--max-ops", "160", "--timeline",
            "32", "--out-dir", str(out), "--chrome-trace",
            str(tmp_path / "trace.json")]
    assert tcli.main(argv) == 0
    printed = capsys.readouterr().out
    assert "performance-cliff detection" in printed
    files = sorted(p.name for p in out.iterdir() if p.suffix == ".json")
    assert files == ["BENCH_torch_history.json",
                     "BENCH_torch_sweep_custom.json",
                     "BENCH_torch_timeline.json"]
    doc = json.loads((out / "BENCH_torch_timeline.json").read_text())
    assert doc["window_ops"] == 32 and doc["n_cells"] == 2
    assert doc["name"] == "torch_timeline"
    for key, cell in doc["cells"].items():
        assert cell["n_windows"] > 0 and "cliff" in cell, key
    assert any(s["name"] == "sweep.launch" for s in doc["spans"])
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(e["name"] == "sweep.dispatch" for e in trace["traceEvents"])
    assert tcli.main(argv + ["--no-history", "--history-check"]) == 0
    from repro_torch.telemetry import history
    hist = history.load_history(str(out))
    rec = hist["records"][-1]
    assert len(hist["records"]) == 1 and rec["meta"]["timeline"] == 32
    history.append_record(rec["kind"], rec["config"], directory=str(out),
                          ops_per_s=rec["ops_per_s"] / 10,
                          geomeans=rec["geomeans"], git_sha="injected")
    capsys.readouterr()
    assert tcli.main(argv[:-2] + ["--no-history", "--history-check",
                                  "--no-save"]) == 1
    assert "REGRESSION" in capsys.readouterr().err
    assert tcli.main(["--traces", "hm_0", "--device", "cpu",
                      "--timeline-overhead-check", "--no-save"]) == 2
    assert tcli.main(["--traces", "hm_0", "--device", "cpu",
                      "--timeline", "0", "--no-save"]) == 2


def test_runner_timelines_and_the_endurance_warning():
    """`run_sweep(timeline_ops=, timelines=)` returns each point's
    windows, equal to the reference runner's; a wear group warns that it
    steps every padded op; span timings fill `dispatch_s`/`block_s`."""
    from repro.sweep.runner import run_sweep as j_run_sweep
    from repro.workloads import TraceCache as JTraceCache
    from repro_torch.sweep.grid import SweepPoint as TPoint
    from repro_torch.sweep.runner import run_sweep as t_run_sweep
    from repro_torch.workloads import TraceCache as TTraceCache
    from repro.sweep.grid import SweepPoint as JPoint
    pts = [("hm_0", "daily", "baseline"), ("hm_0", "daily", "ips")]
    j_tl, t_tl, timings = {}, {}, []
    j_run_sweep(CFG_J, [JPoint(trace=t, mode=m, policy=p)
                        for t, m, p in pts], max_ops=160, timeline_ops=64,
                timelines=j_tl, trace_cache=JTraceCache(use_disk=False))
    t_run_sweep(CFG_T, [TPoint(trace=t, mode=m, policy=p)
                        for t, m, p in pts], max_ops=160, device="cpu",
                timeline_ops=64, timelines=t_tl, timings=timings,
                trace_cache=TTraceCache(use_disk=False))
    j_by = {pt.key: v for pt, v in j_tl.items()}
    assert sorted(pt.key for pt in t_tl) == sorted(j_by)
    for pt, tl in t_tl.items():
        ref = j_by[pt.key]
        assert sorted(tl) == sorted(ref)
        for k in ref:
            assert np.array_equal(tl[k], np.asarray(ref[k])), (pt.key, k)
    assert all(g["dispatch_s"] >= 0 and g["block_s"] >= 0 for g in timings)
    wear = TPoint(trace="hm_0", mode="daily", policy="ips_raro")
    with pytest.warns(RuntimeWarning, match="endurance group"):
        out = {}
        t_run_sweep(CFG_T, [wear], max_ops=96, device="cpu",
                    timeline_ops=32, timelines=out,
                    trace_cache=TTraceCache(use_disk=False))
    assert "wear_peak" in out[wear]


def test_profile_capture_and_device_stats(tmp_path):
    """`profiling.profile` captures a `torch.profiler` Chrome trace into
    its directory and posts its start and stop; the launch counter rides
    `dispatch_stats`; a missing backend degrades to an event."""
    from repro_torch.telemetry import profiling
    tr = Tracer()
    with tr.activate():
        with profiling.profile(str(tmp_path)) as on:
            torch.ones(8).sum()
        profiling.emit_device_events("done")
        with profiling.profile(None) as off:
            pass
    assert on and not off
    names = [s["name"] for s in tr.to_json()]
    assert names[0] == "profile.start" and "profile.stop" in names
    assert "device.stats" in names
    assert os.path.getsize(tmp_path / profiling.TRACE_FILE) > 0
    stats = profiling.dispatch_stats()
    assert stats["ssd_step_launches"] == ssd_step.launches
