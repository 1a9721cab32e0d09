"""The port's CUDA kernels against their plain versions, on the card:
`ssd_step`, the serving path's `ips_repack`, `tiered_decode` (and its
latent form, `latent_decode`; whisper's static cross tier among its
shapes) and `flash_fwd` (MLA's padded widths, whisper's and llava's
prefills among its shapes), and the Mamba2 path's `ssd_intra` (plus the
reduced serving paths of gemma-2b, mamba2-370m, zamba2,
deepseek-v2-lite, arctic, whisper-tiny and llava-next-34b through
them).

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA GPU
and `nvcc`, and skips elsewhere. On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

(`python3 chip_smoke.py` runs the same comparisons at the paper's trace
lengths and the serving shapes, then the whole paper grid and gemma-2b,
mamba2-370m and zamba2-1.2b served at full size.)
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.configs.ssd_paper import PAPER_SSD
from repro_torch.core.ssd.policies.spec import PolicySpec
from repro_torch.core.ssd.endurance.spec import EnduranceSpec
from repro_torch.core.ssd.policies.state import init_state, map_state
from repro_torch.core.ssd.sim import default_params
from repro_torch.kernels.ssd_step import ops as ssd_step
from repro_torch.workloads import build_ops, compress_ops, truncate_trace

pytestmark = pytest.mark.cuda

CFG = PAPER_SSD.scaled(128)
N_LOGICAL = 1 << 16
OPS, PAD = 512, 1024


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def streams():
    """Two cells (hm_0, proj_0): the per-op form and the K = 32 form."""
    traces = []
    for name in ("hm_0", "proj_0"):
        ops = truncate_trace(build_ops(name, N_LOGICAL,
                                       capacity_pages=CFG.total_pages), OPS)
        traces.append({
            "arrival_ms": np.concatenate(
                [ops["arrival_ms"],
                 np.full(PAD, ops["arrival_ms"][-1], np.float32)]),
            "lba": np.concatenate([ops["lba"], np.zeros(PAD, np.int32)]),
            "is_write": np.concatenate(
                [ops["is_write"], np.full(PAD, -1, np.int8)])})
    per_op = {k: np.stack([t[k][:OPS] for t in traces]).astype(
        np.float32 if k == "arrival_ms" else np.int32).reshape(2, OPS, 1)
        for k in traces[0]}
    plans = [compress_ops(t, quantum=256) for t in traces]
    seg = {k: np.stack([p.segs[k] for p in plans]) for k in plans[0].segs}
    pad_t = np.float32([t["arrival_ms"][OPS] for t in traces])
    return {"K=1": per_op, "K=32": seg}, pad_t


def _run(policy, mode, arrays, pad_t, device, packed):
    p = default_params(CFG, policy, 0.05, device="cpu")
    return ssd_step.run_stream(
        CFG, policy, {k: torch.from_numpy(v).to(device)
                      for k, v in arrays.items()},
        init_state(CFG, N_LOGICAL, packed=packed, n_cells=2, device=device),
        closed_loop=(mode == "bursty"),
        params=map_state(lambda x: torch.stack([x, x]).to(device), p),
        n_pad=PAD, pad_t=torch.from_numpy(pad_t).to(device))


@pytest.mark.parametrize("form", ("K=1", "K=32"))
@pytest.mark.parametrize("mode", ("daily", "bursty"))
@pytest.mark.parametrize("policy", (
    "baseline", "ips", "ips_agc", "coop", "dyn_slc", "ips_lazy",
    # the two valid compositions no name registers
    PolicySpec("static", "idle_gap", "migrate", "greedy"),
    PolicySpec("adaptive", "idle_gap", "migrate", "greedy")),
    ids=lambda p: getattr(p, "composition", p))
def test_kernel_equals_plain_version(cuda, streams, policy, mode, form):
    arrays, pad_t = streams
    packed = form == "K=1"
    before = ssd_step.launches
    lat_k, st_k = _run(policy, mode, arrays[form], pad_t, cuda, packed)
    torch.cuda.synchronize()
    assert ssd_step.launches == before + 1
    lat_p, st_p = _run(policy, mode, arrays[form], pad_t,
                       torch.device("cpu"), packed)
    assert torch.equal(lat_k.cpu(), lat_p)
    _assert_state_equal(st_k, st_p, "")


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda, streams):
    arrays, pad_t = streams
    before = ssd_step.launches
    bad = dict(arrays["K=1"], lba=arrays["K=1"]["lba"].astype(np.int64))
    with pytest.raises(TypeError, match="lba"):
        _run("ips", "daily", bad, pad_t, cuda, False)
    no_plan = {k: v for k, v in arrays["K=32"].items()
               if k not in ("src", "scat_lba")}
    with pytest.raises(ValueError, match="hazard plan"):
        _run("ips", "daily", no_plan, pad_t, cuda, False)
    wide = {k: np.concatenate([v, v], axis=2) for k, v in
            arrays["K=32"].items()}
    with pytest.raises(ValueError, match="lanes"):
        _run("ips", "daily", wide, pad_t, cuda, False)
    assert ssd_step.launches == before


COMPOSITIONS = (
    "baseline", "ips", "ips_agc", "coop", "dyn_slc", "ips_lazy",
    PolicySpec("static", "idle_gap", "migrate", "greedy"),
    PolicySpec("adaptive", "idle_gap", "migrate", "greedy"))


def _padded(name, n_ops):
    ops = truncate_trace(build_ops(name, N_LOGICAL,
                                   capacity_pages=CFG.total_pages), n_ops)
    return {"arrival_ms": np.concatenate(
                [ops["arrival_ms"],
                 np.full(PAD, ops["arrival_ms"][-1], np.float32)]),
            "lba": np.concatenate([ops["lba"], np.zeros(PAD, np.int32)]),
            "is_write": np.concatenate(
                [ops["is_write"], np.full(PAD, -1, np.int8)])}


def _job(policy, mode, form, trace, n_ops, cells=1):
    """A `StreamJob` on the CPU of `cells` copies of one trace's first
    `n_ops` ops: the per-op form (K = 1, packed carry) or the K = 32
    segment form of the padded trace (unpacked)."""
    if form == "K=1":
        arrays = {k: v[:n_ops].astype(np.float32 if k == "arrival_ms"
                                      else np.int32).reshape(1, n_ops, 1)
                  for k, v in trace.items()}
        n_pad, pad_t = PAD, trace["arrival_ms"][n_ops]
    else:
        plan = compress_ops(trace, quantum=256)
        arrays = {k: v[None] for k, v in plan.segs.items()}
        n_pad, pad_t = plan.n_pad, plan.pad_t
    p = default_params(CFG, policy, 0.05, device="cpu")
    return ssd_step.StreamJob(
        policy, {k: torch.from_numpy(np.repeat(v, cells, axis=0))
                 for k, v in arrays.items()},
        init_state(CFG, N_LOGICAL, packed=form == "K=1", n_cells=cells,
                   device="cpu"),
        mode == "bursty", map_state(lambda x: torch.stack([x] * cells), p),
        n_pad, torch.full((cells,), float(pad_t), dtype=torch.float32))


def _on(job, dev):
    return job._replace(
        segs={k: v.to(dev) for k, v in job.segs.items()},
        state0=map_state(lambda x: x.to(dev), job.state0),
        params=map_state(lambda x: x.to(dev), job.params),
        pad_t=None if job.pad_t is None else job.pad_t.to(dev))


def _assert_state_equal(got, want, label):
    """Every leaf of `got` (on the card) equals `want` (the plain run),
    value and dtype; the wear carry leaf by leaf, absent on both or
    neither."""
    for field in want._fields:
        g, w = getattr(got, field), getattr(want, field)
        if w is None or isinstance(w, tuple):
            assert (g is None) == (w is None), f"{label}: {field}"
            if w is not None:
                _assert_state_equal(g, w, f"{label}: {field}")
            continue
        g = g.cpu()
        assert g.dtype == w.dtype and torch.equal(g, w), f"{label}: {field}"


def _assert_cells_equal(got, want, label):
    lat_k, st_k = got
    lat_p, st_p = want
    assert torch.equal(lat_k.cpu(), lat_p), f"{label}: latency"
    _assert_state_equal(st_k, st_p, label)


def test_one_launch_of_mixed_jobs_equals_plain_version(cuda):
    """Every composition x both modes x K = 1 and K = 32, each job its
    own stream length, in ONE launch: each cell equals its plain run,
    bit for bit; the block timers are filled."""
    jobs, labels = [], []
    for i, policy in enumerate(COMPOSITIONS):
        for mode in ("daily", "bursty"):
            for form in ("K=1", "K=32"):
                n_ops = 192 + 40 * len(jobs)
                trace = _padded(("hm_0", "proj_0")[len(jobs) % 2], n_ops)
                jobs.append(_job(policy, mode, form, trace, n_ops))
                labels.append(f"{getattr(policy, 'composition', policy)}/"
                              f"{mode}/{form}/{n_ops}")
    # the K = 1 streams all differ in length, the K = 32 ones in S
    assert len({j.segs["lba"].shape for j in jobs}) >= 20
    timer = torch.zeros((len(jobs), len(ssd_step.TIMER_COLUMNS)),
                        dtype=torch.int64, device=cuda)
    before = ssd_step.launches
    got = ssd_step.run_streams(CFG, [_on(j, cuda) for j in jobs],
                               timer=timer)
    torch.cuda.synchronize()
    assert ssd_step.launches == before + 1
    for job, res, label in zip(jobs, got, labels):
        _assert_cells_equal(res, ssd_step.run_streams(CFG, [job])[0], label)
    t = timer.cpu()
    col = {c: i for i, c in enumerate(ssd_step.TIMER_COLUMNS)}
    assert bool((t[:, col["end_ns"]] > t[:, col["start_ns"]]).all())
    assert t[:, col["scanned_ops"]].tolist() == [
        j.segs["lba"].shape[1] * j.segs["lba"].shape[2] for j in jobs]
    assert bool((t[:, col["pads_replayed"]] <= PAD).all())


def test_a_launch_of_more_cells_than_sms_equals_plain_version(cuda):
    """140 cells of 512 ops (more than the card's SMs, so blocks wait for
    a free SM), in 8 jobs: each cell equals the plain run of its trace."""
    traces = {n: _padded(n, OPS) for n in ("hm_0", "proj_0")}
    jobs, plain = [], {}
    for i, policy in enumerate(("baseline", "ips", "ips_agc", "coop")):
        for mode in ("daily", "bursty"):
            cells = 17 + (i + (mode == "daily")) % 2     # 140 in all
            both = [_job(policy, mode, "K=1", traces[n], OPS) for n in
                    traces]
            plain[(policy, mode)] = [ssd_step.run_streams(CFG, [j])[0]
                                     for j in both]
            # cell c is trace c % 2
            job = both[0]._replace(
                segs={k: torch.cat([both[c % 2].segs[k]
                                    for c in range(cells)])
                      for k in both[0].segs},
                state0=map_state(lambda x: torch.cat([x] * cells),
                                 both[0].state0),
                params=map_state(lambda x: torch.cat([x] * cells),
                                 both[0].params),
                pad_t=torch.cat([both[c % 2].pad_t for c in range(cells)]))
            jobs.append(((policy, mode), cells, job))
    assert sum(c for _, c, _ in jobs) == 140
    got = ssd_step.run_streams(CFG, [_on(j, cuda) for _, _, j in jobs])
    torch.cuda.synchronize()
    for ((key, cells, _), (lat, final)) in zip(jobs, got):
        for c in range(cells):
            want_lat, want_st = plain[key][c % 2]
            _assert_cells_equal(
                (lat[c:c + 1], map_state(lambda x: x[c:c + 1], final)),
                (want_lat, want_st), f"{key} cell {c}")


# the wear form: cells that track endurance, the per-op stream only
WEAR_KNOBS = EnduranceSpec(w_rp=4.0, w_erase=1.0, cycle_budget=3.0,
                           rp_budget=0.75, read_penalty_ms=0.05,
                           rp_hysteresis=0.25)
WEAR_POLICIES = (
    "ips_raro", "base_wl", "ips", "baseline", "coop", "ips_agc", "dyn_slc",
    "ips_lazy", PolicySpec("static", "exhaustion", "reprogram_gated", "agc"),
    PolicySpec("wear_min", "exhaustion", "reprogram", "agc"),
    PolicySpec("wear_min", "idle_gap", "migrate", "greedy"),
    PolicySpec("wear_min", "exhaustion", "reprogram_gated", "none"))


def _wear_job(policy, mode, trace, n_ops, cells=1, spec=WEAR_KNOBS):
    """A wear `StreamJob` on the CPU: `cells` copies of one trace's first
    `n_ops` ops, per-op form, no pad tail, small caches so that the gate,
    the fallback, the end of life and the read penalty fire."""
    arrays = {k: np.repeat(v[:n_ops].astype(
        np.float32 if k == "arrival_ms" else np.int32).reshape(1, n_ops, 1),
        cells, axis=0) for k, v in trace.items()}
    p = default_params(CFG, policy, 0.05, spec, device="cpu")
    p = p._replace(cap_basic=torch.tensor(4, dtype=torch.int32),
                   cap_trad=torch.tensor(4, dtype=torch.int32))
    return ssd_step.StreamJob(
        policy, {k: torch.from_numpy(v) for k, v in arrays.items()},
        init_state(CFG, N_LOGICAL, packed=True, n_cells=cells,
                   endurance=True, device="cpu"),
        mode == "bursty", map_state(lambda x: torch.stack([x] * cells), p))


@pytest.mark.parametrize("mode", ("daily", "bursty"))
@pytest.mark.parametrize("policy", WEAR_POLICIES,
                         ids=lambda p: getattr(p, "composition", p))
def test_wear_form_equals_plain_version(cuda, policy, mode):
    """Every composition's wear form, one cell: each WearState and
    SimState leaf equals the plain run."""
    job = _wear_job(policy, mode, _padded("proj_0", 640), 640)
    before = ssd_step.launches
    got = ssd_step.run_streams(CFG, [_on(job, cuda)])[0]
    torch.cuda.synchronize()
    assert ssd_step.launches == before + 1
    want = ssd_step.run_streams(CFG, [job])[0]
    _assert_cells_equal(got, want, f"{policy}/{mode}")
    assert float(want[1].wear.pe_slc.sum()) > 0


@pytest.mark.parametrize("cells", (1, 5, 102))
def test_wear_form_at_many_cells(cuda, cells):
    """1, 5 and 102 wear cells of ips_raro (alternating traces, each its
    own length) in one launch, against the plain run of each trace."""
    traces = {n: _padded(n, 700) for n in ("hm_0", "proj_0")}
    plain = {n: ssd_step.run_streams(
        CFG, [_wear_job("ips_raro", "daily", traces[n], 600)])[0]
        for n in traces}
    jobs = [_wear_job("ips_raro", "daily", traces[("hm_0", "proj_0")[c % 2]],
                      600) for c in range(cells)]
    got = ssd_step.run_streams(CFG, [_on(j, cuda) for j in jobs])
    torch.cuda.synchronize()
    for c, res in enumerate(got):
        _assert_cells_equal(res, plain[("hm_0", "proj_0")[c % 2]],
                            f"cell {c}")


def test_one_launch_mixes_wear_and_plain_cells(cuda):
    """One descriptor table holding wear cells (per-op, every op) beside
    plain cells (per-op and K = 32, with pad tails): each equals its
    plain run, and the block timers count the wear cells' every op."""
    jobs, labels = [], []
    for i, policy in enumerate(("ips_raro", "base_wl", "ips", "coop")):
        trace = _padded(("hm_0", "proj_0")[i % 2], 300 + 50 * i)
        jobs.append(_wear_job(policy, ("daily", "bursty")[i % 2], trace,
                              300 + 50 * i, cells=2))
        labels.append(f"wear {policy}")
        for form in ("K=1", "K=32"):
            jobs.append(_job(("baseline", "ips_agc")[i % 2], "daily", form,
                             trace, 300 + 50 * i, cells=2))
            labels.append(f"plain {form} {i}")
    n_cells = sum(j.segs["lba"].shape[0] for j in jobs)
    timer = torch.zeros((n_cells, len(ssd_step.TIMER_COLUMNS)),
                        dtype=torch.int64, device=cuda)
    before = ssd_step.launches
    got = ssd_step.run_streams(CFG, [_on(j, cuda) for j in jobs],
                               timer=timer)
    torch.cuda.synchronize()
    assert ssd_step.launches == before + 1
    for job, res, label in zip(jobs, got, labels):
        _assert_cells_equal(res, ssd_step.run_streams(CFG, [job])[0], label)
    t = timer.cpu()
    col = {c: i for i, c in enumerate(ssd_step.TIMER_COLUMNS)}
    row = 0
    for job in jobs:
        c = job.segs["lba"].shape[0]
        if job.params.endurance is not None:
            assert t[row:row + c, col["pads_replayed"]].tolist() == [0] * c
            assert t[row:row + c, col["scanned_ops"]].tolist() == \
                [job.segs["lba"].shape[1]] * c
        row += c


def test_wrapper_refuses_what_the_wear_form_does_not_take(cuda):
    job = _wear_job("ips_raro", "daily", _padded("hm_0", 64), 64)
    before = ssd_step.launches
    with pytest.raises(ValueError, match="every op"):
        ssd_step.run_streams(CFG, [_on(job._replace(
            n_pad=8, pad_t=torch.zeros(1)), cuda)])
    with pytest.raises(ValueError, match="endurance"):
        ssd_step.run_streams(CFG, [_on(job._replace(
            params=job.params._replace(endurance=None)), cuda)])
    assert ssd_step.launches == before


def test_shared_memory_probe_reads_a_latency(cuda):
    before = ssd_step.launches
    probe = ssd_step.smem_chase(1 << 16, cuda)
    assert ssd_step.launches == before
    assert probe["steps"] == 1 << 16
    assert 5.0 < probe["cycles_per_load"] < 500.0
    assert 500.0 < probe["clock_mhz"] < 3000.0


# the probe form: the telemetry probe's rows out of the recurrence
def _with_probe(job, window):
    return job._replace(window_ops=window)


@pytest.mark.parametrize("form,window", (("K=1", 96), ("K=32", 64),
                                         ("wear", 64)))
@pytest.mark.parametrize("mode", ("daily", "bursty"))
@pytest.mark.parametrize("policy", ("baseline", "ips", "ips_agc", "coop"))
def test_probe_form_equals_plain_version(cuda, policy, mode, form, window):
    """The probe form of each kernel form, two cells: head columns,
    counter snapshots (the pad tail's boundaries among them) and wear
    peaks equal the plain run bit for bit; latencies and carries equal
    the probe-off launch (the probe only observes)."""
    trace = _padded("hm_0", 448)
    if form == "wear":
        job = _wear_job({"ips": "ips_raro", "coop": "base_wl"}.get(
            policy, policy), mode, trace, 448, cells=2)
    else:
        job = _job(policy, mode, form, trace, 448, cells=2)
    on = _with_probe(job, window)
    before = ssd_step.launches
    got = ssd_step.run_streams(CFG, [_on(on, cuda)])[0]
    off = ssd_step.run_streams(CFG, [_on(job, cuda)])[0]
    torch.cuda.synchronize()
    assert ssd_step.launches == before + 2
    want = ssd_step.run_streams(CFG, [on])[0]
    _assert_cells_equal(got, want, f"{policy}/{mode}/{form} probe")
    rows = got[1].timeline
    n_win = -(-(job.segs["lba"][0].numel() + job.n_pad) // window)
    assert rows.snap.shape == (2, n_win, 10)
    assert (rows.wear_peak is not None) == (form == "wear")
    assert torch.equal(got[0], off[0])
    _assert_state_equal(got[1]._replace(timeline=None),
                        map_state(lambda x: x.cpu(), off[1]),
                        f"{policy}/{mode}/{form} on vs off")


def test_one_launch_mixes_probe_and_plain_jobs(cuda):
    """Probe jobs (per-op with a pad tail, K = 32, wear) beside jobs with
    the probe off, in ONE launch: each equals its own plain run, and the
    probe-off jobs equal their plain results, with no timeline."""
    jobs = []
    for i, (policy, form) in enumerate((("ips", "K=1"), ("coop", "K=32"),
                                        ("baseline", "K=1"))):
        trace = _padded(("hm_0", "proj_0")[i % 2], 320 + 64 * i)
        job = _job(policy, "daily", form, trace, 320 + 64 * i)
        jobs += [_with_probe(job, 64 * (i + 1)), job]
    jobs.append(_with_probe(_wear_job("ips_raro", "daily",
                                      _padded("proj_0", 300), 300), 128))
    before = ssd_step.launches
    got = ssd_step.run_streams(CFG, [_on(j, cuda) for j in jobs])
    torch.cuda.synchronize()
    assert ssd_step.launches == before + 1
    for i, (job, res) in enumerate(zip(jobs, got)):
        want = ssd_step.run_streams(CFG, [job])[0]
        _assert_cells_equal(res, want, f"job {i}")
        assert (res[1].timeline is None) == (job.window_ops is None)


# ---------------------------------------------------------------------------
# the host tier: host_tier.cu, and its sub-op streams through ssd_step.cu
# ---------------------------------------------------------------------------

from repro_torch.core.ssd import fleet as fleet_mod  # noqa: E402
from repro_torch.hostcache.model import as_hc_params, init_hc  # noqa: E402
from repro_torch.hostcache.spec import HostCacheSpec  # noqa: E402
from repro_torch.kernels.host_tier import ops as host_tier  # noqa: E402
from repro_torch.kernels.host_tier import ref as tier_ref  # noqa: E402
from repro_torch.workloads import ir as ir_mod  # noqa: E402
from repro_torch.workloads.generators import flush_burst  # noqa: E402

# the CPU tests' geometries (tests/torch_port_util.HOST_CASES: every mode
# x promote x flush), the default 128 x 8, 12 x 3 and 32 x 16 (the way
# count read at run time, and the largest the kernel specialises), and
# 1024 x 8, whose arrays (104 KB) exceed the kernel's shared-memory
# budget: its cells work in device memory
HOST_SPECS = tuple(
    HostCacheSpec(mode=m, promote=p, flush=f, sets=(8, 16)[i % 2],
                  ways=(2, 4)[i % 2], flush_per_op=(1, 2, 4)[i % 3],
                  flush_gap_ms=0.5)
    for i, (m, p, f) in enumerate(
        (m, p, f) for m in ("wb", "wt", "wa") for p in ("always", "nth")
        for f in ("watermark", "idle"))) + (
    HostCacheSpec(), HostCacheSpec(sets=12, ways=3, flush_per_op=2),
    HostCacheSpec(sets=32, ways=16, flush="idle", flush_gap_ms=0.5),
    HostCacheSpec(sets=1024, ways=8, flush_per_op=4))


def _host_trace(name, access, n_ops, n_pad=64):
    """flush_burst (its generator; bursty: the sequential rewrite) or an
    MSR name, the first `n_ops` ops and `n_pad` tail pads."""
    if name == "flush_burst":
        tr = flush_burst(N_LOGICAL, capacity_pages=CFG.total_pages)
        if access == "bursty":
            tr = tr.to_bursty(N_LOGICAL)
        ops = tr.truncate(n_ops).compile()
    else:
        ops = build_ops(name, N_LOGICAL, mode=access,
                        capacity_pages=CFG.total_pages)
    return ir_mod.repad_ops({k: (v[:n_ops] if isinstance(v, np.ndarray)
                                 else v) for k, v in ops.items()},
                            n_ops + n_pad)


def _tier_jobs(dev, n_ops=600):
    jobs = []
    for spec in HOST_SPECS:
        for access in ("daily", "bursty"):
            ops = fleet_mod.stack_ops(
                [_host_trace(n, access, n_ops)
                 for n in ("flush_burst", "hm_1")], device=dev)
            p = map_state(lambda x: torch.stack([x, x]),
                          as_hc_params(spec, dev))
            jobs.append(tier_ref.TierJob(spec, ops, p,
                                         init_hc(spec, 2, device=dev),
                                         access == "bursty", rows=True))
    return jobs


def test_host_tier_kernel_equals_plain_version(cuda):
    """Every spec x both access modes x two traces in ONE launch, cells in
    shared memory and in device memory side by side: the sub-op streams,
    the absorbed flags, the host rows and the final HCState equal the
    plain version's, bit for bit."""
    assert any(host_tier._array_bytes(s) > host_tier.SMEM_BUDGET
               for s in HOST_SPECS)
    jobs = _tier_jobs("cpu")
    before = host_tier.launches
    got = host_tier.tier_pass([tier_ref.TierJob(
        j.spec, {k: v.to(cuda) for k, v in j.ops.items()},
        map_state(lambda x: x.to(cuda), j.params),
        map_state(lambda x: x.to(cuda), j.hc0), j.closed_loop, True)
        for j in jobs])
    torch.cuda.synchronize()
    assert host_tier.launches == before + 1
    for job, res in zip(jobs, got):
        want = tier_ref.tier_pass_ref(job)
        label = f"{job.spec.tag}/{'bursty' if job.closed_loop else 'daily'}"
        for k in want.sub:
            assert torch.equal(res.sub[k].cpu(), want.sub[k]), (label, k)
        assert torch.equal(res.absorbed.cpu(), want.absorbed), label
        assert torch.equal(res.rows.cpu(), want.rows), label
        _assert_state_equal(res.hc, want.hc, label)


def test_host_tier_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    job = _tier_jobs(cuda, n_ops=32)[0]
    before = host_tier.launches
    with pytest.raises(TypeError, match="lba"):
        host_tier.tier_pass([job._replace(ops=dict(
            job.ops, lba=job.ops["lba"].to(torch.int64)))])
    with pytest.raises(ValueError, match="tag"):
        host_tier.tier_pass([job._replace(hc0=job.hc0._replace(
            tag=job.hc0.tag[:, :4]))])
    cells = job.ops["lba"].shape[0]
    n_probe = len(host_tier.PROBE_COLUMNS)
    for probe in (torch.zeros((1, n_probe), dtype=torch.int64, device=cuda),
                  torch.zeros((cells, n_probe), dtype=torch.int32,
                              device=cuda),
                  torch.zeros((n_probe, cells), dtype=torch.int64,
                              device=cuda).t(),
                  torch.zeros((cells, n_probe), dtype=torch.int64)):
        with pytest.raises(ValueError, match="probe"):
            host_tier.tier_pass([job], probe=probe)
    assert host_tier.launches == before


def test_host_tier_probe_form_equals_probe_off(cuda):
    """The probe form, every spec x both access modes x two traces (two
    cells a job) in ONE launch: every output bit for bit the probe-off
    launch's, each cell's row counting its T ops, and its parts' cycles
    within its whole."""
    jobs = _tier_jobs(cuda)
    off = host_tier.tier_pass(jobs)
    cells = sum(j.ops["lba"].shape[0] for j in jobs)
    probe = torch.zeros((cells, len(host_tier.PROBE_COLUMNS)),
                        dtype=torch.int64, device=cuda)
    before = host_tier.launches
    on = host_tier.tier_pass(jobs, probe=probe)
    torch.cuda.synchronize()
    assert host_tier.launches == before + 1
    for job, a, b in zip(jobs, on, off):
        label = f"{job.spec.tag}/{'bursty' if job.closed_loop else 'daily'}"
        for k in b.sub:
            assert torch.equal(a.sub[k], b.sub[k]), (label, k)
        assert torch.equal(a.absorbed, b.absorbed), label
        assert torch.equal(a.rows, b.rows), label
        _assert_state_equal(a.hc, map_state(lambda x: x.cpu(), b.hc),
                            label)
    col = {c: i for i, c in enumerate(host_tier.PROBE_COLUMNS)}
    rows = probe.cpu()
    t_len = torch.tensor([j.ops["lba"].shape[1] for j in jobs
                          for _ in range(j.ops["lba"].shape[0])])
    assert torch.equal(rows[:, col["ops"]], t_len)
    parts = rows[:, [col[c] for c in ("wait", "scan", "promote", "flush",
                                      "store")]]
    assert bool((parts >= 0).all()) and bool((rows[:, col["cycles"]] > 0).all())
    assert bool((parts.sum(1) <= rows[:, col["cycles"]]).all())


@pytest.mark.parametrize("mode", ("daily", "bursty"))
@pytest.mark.parametrize("policy", ("baseline", "ips", "ips_agc", "coop"))
def test_interior_pad_streams_equal_plain_version(cuda, policy, mode):
    """A host cell's sub-op stream — pads at every absorbed op and every
    empty slot, carrying the trace op's arrival and lba 0 — through the
    per-op form, the probe form (K slots a trace op a window) and the
    wear form: equal to the plain version, and the cell runs to its
    end, not to its first pad."""
    spec = HostCacheSpec(sets=8, ways=2)
    trace = _host_trace("flush_burst", mode, 300)
    ops = fleet_mod.stack_ops([trace], device="cpu")
    out = tier_ref.tier_pass_ref(tier_ref.TierJob(
        spec, ops, map_state(lambda x: x[None], as_hc_params(spec, "cpu")),
        init_hc(spec, 1, device="cpu"), mode == "bursty"))
    kinds = out.sub["is_write"]
    assert bool((kinds[0, :100] < 0).any()) and bool((kinds >= 0).any())
    n_sub = kinds.shape[1]
    segs = {k: v.reshape(1, n_sub, 1) for k, v in out.sub.items()}
    for window, wear in ((None, False), (4 * 64, False), (4 * 128, True)):
        p = default_params(CFG, policy, 0.05,
                           EnduranceSpec() if wear else None, device="cpu")
        job = ssd_step.StreamJob(
            policy, segs, init_state(CFG, N_LOGICAL, n_cells=1,
                                     endurance=wear, device="cpu"),
            mode == "bursty", map_state(lambda x: x[None], p), 0, None,
            window)
        timer = torch.zeros((1, len(ssd_step.TIMER_COLUMNS)),
                            dtype=torch.int64, device=cuda)
        got = ssd_step.run_streams(CFG, [_on(job, cuda)], timer=timer)[0]
        torch.cuda.synchronize()
        _assert_cells_equal(got, ssd_step.run_streams(CFG, [job])[0],
                            f"{policy}/{mode}/{window}/{wear}")
        col = ssd_step.TIMER_COLUMNS.index("scanned_ops")
        assert int(timer[0, col]) == n_sub


def test_host_grid_on_the_card_equals_the_cpu(cuda):
    """`run_fleets` with every host spec's fleet and a device-only fleet:
    ONE host_tier launch and ONE ssd_step launch on the card, every
    result (probe on: timelines and host windows too) equal to the same
    call on the CPU, bit for bit."""
    groups = []
    for i, spec in enumerate(HOST_SPECS):
        policy = ("baseline", "ips", "ips_agc", "coop")[i % 4]
        for access in ("daily", "bursty"):
            ops = fleet_mod.stack_ops(
                [_host_trace(n, access, 128)
                 for n in ("flush_burst", "hm_1")], device="cpu")
            p = default_params(CFG, policy, 0.05, device="cpu")._replace(
                hostcache=as_hc_params(spec, "cpu"))
            groups.append(fleet_mod.FleetGroup(
                policy, ops, map_state(lambda x: torch.stack([x, x]), p),
                access == "bursty", hostcache=spec))
    groups.append(fleet_mod.FleetGroup(
        "ips", groups[0].ops,
        map_state(lambda x: torch.stack([x, x]),
                  default_params(CFG, "ips", 0.05, device="cpu")), False))

    def on(g):
        return g._replace(ops={k: v.to(cuda) for k, v in g.ops.items()},
                          params=map_state(lambda x: x.to(cuda), g.params))

    t0, s0 = host_tier.launches, ssd_step.launches
    got = fleet_mod.run_fleets(CFG, [on(g) for g in groups],
                               n_logical=N_LOGICAL, timeline_ops=64)
    torch.cuda.synchronize()
    assert (host_tier.launches - t0, ssd_step.launches - s0) == (1, 1)
    want = fleet_mod.run_fleets(CFG, groups, n_logical=N_LOGICAL,
                                timeline_ops=64)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_cells_equal(g, w, f"group {i}")


# ---------------------------------------------------------------------------
# the serving path's kernels: ips_repack, tiered_decode, flash_fwd
# ---------------------------------------------------------------------------

from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_ref  # noqa: E402
from repro_torch.kernels.ips_repack import ops as repack_ops  # noqa: E402
from repro_torch.kernels.ips_repack.ref import (  # noqa: E402
    page_layout, quantize_into_ref, quantize_rows_ref, repack_ref)
from repro_torch.kernels.tiered_attention import ops as tiered_ops  # noqa: E402
from repro_torch.kernels.tiered_attention.ref import (  # noqa: E402
    dense_tier_partial_ref, latent_tier_partial_ref)
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as ssd_ref  # noqa: E402


def _gen(seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


def _randn(gen, *shape, scale=1.0, dtype=torch.float32):
    return (scale * torch.randn(shape, generator=gen, device="cuda")).to(
        dtype)


def _refuse_plain(monkeypatch, module, name):
    """Make the plain version raise, so a CUDA call that reached it
    fails."""
    def refuse(*a, **k):
        raise AssertionError(f"{name} ran on a CUDA tensor")
    monkeypatch.setattr(module.ref, name, refuse)


class TestIpsRepackKernel:
    @pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
    @pytest.mark.parametrize("rows,feat,group", [
        (4096, 256, 64), (300, 64, 16), (257, 1024, 64), (64, 128, 32),
        (33, 8, 2)])
    def test_tier_form_bit_exact(self, cuda, monkeypatch, rows, feat, group,
                                 dtype):
        x = _randn(_gen(rows + feat), rows, feat, scale=5.0, dtype=dtype)
        x[::7] = 0.0
        want = quantize_rows_ref(x, group)
        _refuse_plain(monkeypatch, repack_ops, "quantize_rows_ref")
        before = repack_ops.LAUNCHER.launches
        got = repack_ops.quantize_rows(x, group)
        torch.cuda.synchronize()
        assert repack_ops.LAUNCHER.launches == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    @pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
    @pytest.mark.parametrize("feat,group", [
        (768, 2), (768, 6), (768, 48), (768, 64), (768, 128), (768, 256),
        (16384, 16384)])
    def test_every_group_bit_exact(self, cuda, monkeypatch, feat, group,
                                   dtype):
        """Every even group that divides feat, as the reference takes it:
        powers of two of 8-value lanes up to 32 reduce by shuffles, the
        others (6: 3 lanes of 2, 48: 6 lanes of 8, 16384: 2,048 lanes,
        more than a block's 1,024 chunks) through shared memory."""
        x = _randn(_gen(group), 333 if feat < 4096 else 20, feat, scale=4.0,
                   dtype=dtype)
        x[::5, :group] = 0.0
        want = quantize_rows_ref(x, group)
        _refuse_plain(monkeypatch, repack_ops, "quantize_rows_ref")
        got = repack_ops.quantize_rows(x, group)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    @pytest.mark.parametrize("shape,t,start", [
        ((18, 4, 1024, 1, 256), 256, 1024),     # gemma-2b, one page
        ((18, 4, 1024, 1, 256), 1024, 2500),    # four pages, start clamped
        ((6, 4, 1024, 32, 64), 512, 1536),      # zamba2-1.2b's shared block
    ])
    def test_in_place_form_on_hot_tier_slices(self, cuda, monkeypatch, shape,
                                              t, start):
        """K and V in ONE launch, read from the strided hot-tier slice
        `[:, :, :t]` and written into bf16-scaled dense tiers at the
        watermark: every byte of both tiers equals the plain version's
        (the rest of each tier untouched)."""
        gen = _gen(t + start)
        n, b, w, hkv, hd = shape
        s_dense = 3200
        chans, want = [], []
        for _ in range(2):
            hot = _randn(gen, n, b, w, hkv, hd, scale=3.0,
                         dtype=torch.bfloat16)
            pk = torch.randint(0, 256, (n, b, s_dense, hkv, hd // 2),
                               dtype=torch.uint8, generator=gen,
                               device="cuda")
            sc = _randn(gen, n, b, s_dense, hkv, hd // 64,
                        dtype=torch.bfloat16)
            chans.append((hot[:, :, :t], pk, sc))
            want.append((pk.clone(), sc.clone()))
        quantize_into_ref([(src, pk, sc) for (src, _, _), (pk, sc)
                           in zip(chans, want)], start, 64)
        _refuse_plain(monkeypatch, repack_ops, "quantize_into_ref")
        before = repack_ops.LAUNCHER.launches
        repack_ops.quantize_into(chans, start, 64)
        torch.cuda.synchronize()
        assert repack_ops.LAUNCHER.launches == before + 1
        for (_, pk, sc), (want_pk, want_sc) in zip(chans, want):
            assert torch.equal(pk, want_pk) and torch.equal(sc, want_sc)

    @pytest.mark.parametrize("pages", (1, 5, 128))
    @pytest.mark.parametrize("tokens,feat,group,tail", [
        (256, 1024, 64, 4096), (16, 64, 16, 0), (8, 256, 64, 36)])
    def test_arena_in_place_keeps_the_stale_tail(self, cuda, tokens, feat,
                                                 group, tail, pages):
        gen = _gen(tokens)
        arena = torch.randint(0, 256, (pages, tokens * feat * 2 + tail),
                              dtype=torch.uint8, generator=gen, device="cuda")
        arena[:, :tokens * feat * 2] = _randn(
            gen, pages, tokens * feat, scale=3.0,
            dtype=torch.bfloat16).view(torch.uint8)
        before = arena.clone()
        ptr = arena.data_ptr()
        out = repack_ops.repack_arena(arena, tokens=tokens, feat=feat,
                                      group=group)
        torch.cuda.synchronize()
        assert out.data_ptr() == ptr
        assert torch.equal(arena, repack_ref(before, tokens, feat, group))
        _, packed_b, scale_b = page_layout(tokens, feat, group)
        assert torch.equal(arena[:, packed_b + scale_b:],
                           before[:, packed_b + scale_b:])

    def test_refused_launches_raise(self, cuda):
        before = repack_ops.LAUNCHER.launches
        x = torch.zeros((8, 256), dtype=torch.bfloat16, device="cuda")
        # groups the reference refuses too: odd, and not a divisor of feat
        with pytest.raises(ValueError, match="group"):
            repack_ops.quantize_rows(x, 7)
        with pytest.raises(ValueError, match="group"):
            repack_ops.quantize_rows(x, 96)
        with pytest.raises(TypeError, match="dtype"):
            repack_ops.quantize_rows(x.to(torch.float16), 64)
        with pytest.raises(ValueError, match="contiguous"):
            repack_ops.quantize_rows(x.t(), 8)
        arena = torch.zeros((2, 100), dtype=torch.uint8, device="cuda")
        with pytest.raises(ValueError, match="page_bytes"):
            repack_ops.repack_arena(arena, tokens=4, feat=16, group=16)
        big = torch.zeros((1, 4096 * 1024 * 2), dtype=torch.uint8,
                          device="cuda")
        with pytest.raises(ValueError, match="shared memory"):
            repack_ops.repack_arena(big, tokens=4096, feat=1024, group=64)
        assert repack_ops.LAUNCHER.launches == before

    def test_cpu_tensors_take_the_plain_version(self, cuda):
        before = repack_ops.LAUNCHER.launches
        x = torch.randn(16, 64).to(torch.bfloat16)
        got = repack_ops.quantize_rows(x, 16)
        assert got[0].device.type == "cpu"
        assert repack_ops.LAUNCHER.launches == before
        repack_ops.quantize_rows(x.cuda(), 16)
        assert repack_ops.LAUNCHER.launches == before + 1


class TestTieredDecodeKernel:
    @staticmethod
    def _tier(gen, b, s, hkv, g, hd, group, sc_dtype):
        k4, ksc = quantize_rows_ref(_randn(gen, b * s * hkv, hd, scale=2.0),
                                    group)
        v4, vsc = quantize_rows_ref(_randn(gen, b * s * hkv, hd, scale=2.0),
                                    group)
        shape4 = (b, s, hkv, hd // 2)
        shape_sc = (b, s, hkv, hd // group)
        return (_randn(gen, b, hkv, g, hd), k4.reshape(shape4),
                ksc.reshape(shape_sc).to(sc_dtype), v4.reshape(shape4),
                vsc.reshape(shape_sc).to(sc_dtype))

    @pytest.mark.parametrize("form", ("float32", "bf16"))
    @pytest.mark.parametrize("fill", ("empty", "partial", "full"))
    @pytest.mark.parametrize("b,s,hkv,g,hd,group", [
        (2, 64, 2, 4, 32, 16), (2, 128, 1, 7, 64, 64), (2, 32, 4, 1, 64, 32),
        (4, 3200, 1, 8, 256, 64), (1, 100, 2, 16, 128, 32),
        (3, 40, 1, 2, 16, 8)])
    def test_equals_plain_version(self, cuda, monkeypatch, b, s, hkv, g, hd,
                                  group, fill, form):
        deq = torch.float32 if form == "float32" else torch.bfloat16
        tier = self._tier(_gen(s + g), b, s, hkv, g, hd, group, deq)
        dense_len = {"empty": 0, "partial": s - s // 3 - 1, "full": s}[fill]
        want = dense_tier_partial_ref(*tier, dense_len, group, deq)
        _refuse_plain(monkeypatch, tiered_ops, "dense_tier_partial_ref")
        before = tiered_ops.LAUNCHER.launches
        got = tiered_ops.dense_tier_partial(*tier, dense_len, group=group,
                                            deq_dtype=deq)
        torch.cuda.synchronize()
        assert tiered_ops.LAUNCHER.launches == before + 1
        for name, a, w in zip(("m", "l", "acc"), got, want):
            # float32 partials, another summation order: 2e-4, the
            # reference's kernel tolerance
            torch.testing.assert_close(a, w, rtol=2e-4, atol=2e-4,
                                       msg=name)
        if fill == "empty":
            assert bool((got[0] == -1e30).all()) and bool((got[1] == 0).all())
            assert bool((got[2] == 0).all())

    @pytest.mark.parametrize("form", ("float32", "bf16"))
    @pytest.mark.parametrize("fill", ("0", "1", "split-1", "split+1", "1000",
                                      "full"))
    @pytest.mark.parametrize("g,hd", [(1, 64), (2, 16), (3, 256), (8, 256),
                                      (16, 128), (5, 32), (16, 256)])
    def test_split_equals_plain_version(self, cuda, monkeypatch, g, hd, fill,
                                        form):
        """S split over blocks and merged: splits of 32 tokens at this
        shape (B * Hkv = 4; 128 for G = 1), the last one partly past
        dense_len."""
        b, s, hkv, group = 2, 1280, 2, min(64, hd)
        deq = torch.float32 if form == "float32" else torch.bfloat16
        tier = self._tier(_gen(g * hd), b, s, hkv, g, hd, group, deq)
        split = tiered_ops.split_plan(1000, b, hkv, g)[0]
        dense_len = {"0": 0, "1": 1, "split-1": split - 1,
                     "split+1": split + 1, "1000": 1000, "full": s}[fill]
        want = dense_tier_partial_ref(*tier, dense_len, group, deq)
        _refuse_plain(monkeypatch, tiered_ops, "dense_tier_partial_ref")
        before = tiered_ops.LAUNCHER.launches
        got = tiered_ops.dense_tier_partial(*tier, dense_len, group=group,
                                            deq_dtype=deq)
        torch.cuda.synchronize()
        assert tiered_ops.LAUNCHER.launches == before + 1
        for name, a, w in zip(("m", "l", "acc"), got, want):
            # float32 partials, another summation order: 2e-4
            torch.testing.assert_close(a, w, rtol=2e-4, atol=2e-4,
                                       msg=name)
        if dense_len == 0:
            assert bool((got[0] == -1e30).all()) and bool((got[1] == 0).all())
            assert bool((got[2] == 0).all())

    @pytest.mark.parametrize("form", ("float32", "bf16"))
    @pytest.mark.parametrize("frames", (1500, 1499, 77))
    def test_cross_tier_equals_plain_version(self, cuda, monkeypatch,
                                             frames, form):
        """whisper-tiny's static cross tier: the whole tier is dense
        (dense_len = S = F, 1500 no multiple of the page or of a split),
        at its decode shape (B 4, Hkv 6, G 1, hd 64, group 64)."""
        b, hkv, g, hd, group = 4, 6, 1, 64, 64
        deq = torch.float32 if form == "float32" else torch.bfloat16
        tier = self._tier(_gen(frames), b, frames, hkv, g, hd, group, deq)
        tokens, splits = tiered_ops.split_plan(frames, b, hkv, g)
        assert (splits - 1) * tokens < frames <= splits * tokens
        want = dense_tier_partial_ref(*tier, frames, group, deq)
        _refuse_plain(monkeypatch, tiered_ops, "dense_tier_partial_ref")
        got = tiered_ops.dense_tier_partial(*tier, frames, group=group,
                                            deq_dtype=deq)
        for name, a, w in zip(("m", "l", "acc"), got, want):
            torch.testing.assert_close(a, w, rtol=2e-4, atol=2e-4,
                                       msg=name)

    def test_last_split_reads_nothing_past_dense_len(self, cuda):
        """A tier that ends at dense_len inside a larger buffer whose rows
        past it are NaN: a load past dense_len would poison the partial
        (0 * NaN), so the kernel must load nothing there."""
        b, hkv, g, hd, group, frames = 1, 6, 1, 64, 64, 1500
        q, k4, ksc, v4, vsc = self._tier(_gen(5), b, frames + 256, hkv, g,
                                         hd, group, torch.bfloat16)
        for sc in (ksc, vsc):
            sc[:, frames:] = float("nan")
        k4[:, frames:] = 0x88
        got = tiered_ops.dense_tier_partial(
            q, k4[:, :frames], ksc[:, :frames], v4[:, :frames],
            vsc[:, :frames], frames, group=group, deq_dtype=torch.bfloat16)
        want = dense_tier_partial_ref(
            q, k4[:, :frames], ksc[:, :frames], v4[:, :frames],
            vsc[:, :frames], frames, group, torch.bfloat16)
        for name, a, w in zip(("m", "l", "acc"), got, want):
            assert bool(torch.isfinite(a).all()), name
            torch.testing.assert_close(a, w, rtol=2e-4, atol=2e-4,
                                       msg=name)

    def test_the_two_forms_differ_by_the_bf16_rounding(self, cuda):
        tier = self._tier(_gen(9), 2, 256, 1, 8, 256, 64, torch.bfloat16)
        f32 = tiered_ops.dense_tier_partial(*tier, 200, group=64)
        bf = tiered_ops.dense_tier_partial(*tier, 200, group=64,
                                           deq_dtype=torch.bfloat16)
        assert not torch.equal(f32[2], bf[2])
        # normalized outputs: bf16's rounding of the tier (2^-9 relative)
        # moves both the scores and the values of |v| < 16; 0.1 bounds it
        out32 = f32[2] / f32[1][..., None]
        out16 = bf[2] / bf[1][..., None]
        torch.testing.assert_close(out32, out16, rtol=0.0, atol=0.1)

    def test_refused_launches_raise(self, cuda):
        tier = self._tier(_gen(3), 1, 32, 1, 4, 64, 16, torch.bfloat16)
        before = tiered_ops.LAUNCHER.launches
        with pytest.raises(ValueError, match="dense_len"):
            tiered_ops.dense_tier_partial(*tier, 33, group=16)
        with pytest.raises(ValueError, match="head_dim"):
            tiered_ops.dense_tier_partial(tier[0][..., :48].contiguous(),
                                          *tier[1:], 8, group=16)
        with pytest.raises(TypeError, match="v4_sc"):
            tiered_ops.dense_tier_partial(*tier[:4], tier[4].float(), 8,
                                          group=16)
        with pytest.raises(ValueError, match="query heads"):
            q = torch.zeros((1, 1, 17, 64), device="cuda")
            tiered_ops.dense_tier_partial(q, *tier[1:], 8, group=16)
        assert tiered_ops.LAUNCHER.launches == before

    def test_cpu_tensors_take_the_plain_version(self, cuda):
        tier = self._tier(_gen(4), 1, 32, 1, 4, 64, 16, torch.bfloat16)
        before = tiered_ops.LAUNCHER.launches
        cpu = tiered_ops.dense_tier_partial(*(t.cpu() for t in tier), 20,
                                            group=16)
        assert cpu[0].device.type == "cpu"
        assert tiered_ops.LAUNCHER.launches == before
        tiered_ops.dense_tier_partial(*tier, 20, group=16)
        assert tiered_ops.LAUNCHER.launches == before + 1


class TestFlashKernel:
    @pytest.mark.parametrize("b,s,h,hkv,hd,dtype,tol", [
        (4, 2048, 8, 1, 256, torch.bfloat16, 1e-2),
        # whisper-tiny's decoder prefill (H 6, Hkv 6, hd 64), and
        # llava-next-34b's 576 patches + 2048 tokens at its heads
        (4, 2048, 6, 6, 64, torch.bfloat16, 1e-2),
        (4, 2624, 56, 8, 128, torch.bfloat16, 1e-2),
        (1, 512, 8, 1, 256, torch.float32, 2e-5),
        (2, 64, 6, 2, 32, torch.float32, 2e-5),
        (2, 32, 4, 1, 64, torch.float32, 2e-5),
        (2, 48, 4, 4, 16, torch.float32, 2e-5),
        (2, 1000, 8, 1, 256, torch.bfloat16, 1e-2),
        (1, 333, 6, 2, 128, torch.float32, 2e-5),
        (1, 1, 2, 1, 64, torch.float32, 2e-5)])
    def test_equals_plain_version(self, cuda, monkeypatch, b, s, h, hkv, hd,
                                  dtype, tol):
        gen = _gen(s + hd)
        q = _randn(gen, b, s, h, hd, dtype=dtype)
        k = _randn(gen, b, s, hkv, hd, dtype=dtype)
        v = _randn(gen, b, s, hkv, hd, dtype=dtype)
        want = flash_ref(q, k, v, chunk=64)
        _refuse_plain(monkeypatch, flash_ops, "flash_ref")
        before = flash_ops.LAUNCHER.launches
        out, lse = flash_ops.flash_fwd(q, k, v)
        torch.cuda.synchronize()
        assert flash_ops.LAUNCHER.launches == before + 1
        # float32 arithmetic on both sides, other orders; bf16 inputs are
        # held at 1e-2 as the serving path's check holds them
        torch.testing.assert_close(out, want[0], rtol=tol, atol=tol)
        torch.testing.assert_close(lse, want[1], rtol=tol, atol=tol)

    @pytest.mark.parametrize("s", (1, 17, 333, 1000))
    @pytest.mark.parametrize("g", (1, 8))
    @pytest.mark.parametrize("hd", (16, 32, 64, 128, 256))
    def test_wgmma_form_equals_plain_version(self, cuda, monkeypatch, hd, g,
                                             s):
        """The bf16 form on the tensor cores, at every head_dim, with and
        without GQA, at S below one 128-row tile and off its multiples."""
        b, hkv = 2, 2
        gen = _gen(hd * s + g)
        q = _randn(gen, b, s, hkv * g, hd, dtype=torch.bfloat16)
        k = _randn(gen, b, s, hkv, hd, dtype=torch.bfloat16)
        v = _randn(gen, b, s, hkv, hd, dtype=torch.bfloat16)
        want = flash_ref(q, k, v, chunk=64)
        _refuse_plain(monkeypatch, flash_ops, "flash_ref")
        before = flash_ops.LAUNCHER.launches
        out, lse = flash_ops.flash_fwd(q, k, v)
        torch.cuda.synchronize()
        assert flash_ops.LAUNCHER.launches == before + 1
        # bf16 inputs: 1e-2, as the serving path's check holds the kernel
        # (P in float32: test_wgmma_form_keeps_p_in_float32)
        torch.testing.assert_close(out, want[0], rtol=1e-2, atol=1e-2)
        torch.testing.assert_close(lse, want[1], rtol=1e-2, atol=1e-2)

    @pytest.mark.parametrize("b,s,h,hkv,hd", [(2, 1000, 14, 2, 128),
                                              (2, 333, 8, 1, 256),
                                              (2, 600, 6, 6, 64)])
    def test_wgmma_form_keeps_p_in_float32(self, cuda, monkeypatch,
                                           b, s, h, hkv, hd):
        """P reaches the second product as three bf16 terms that sum to
        it exactly: within 1e-5 of max |output| of the float32 plain
        version (one bf16 term is some 1e-3 off, two some 2e-6:
        tests/test_torch_serve_kernels.py emulates each)."""
        gen = _gen(s * hd + h)
        q = _randn(gen, b, s, h, hd, dtype=torch.bfloat16)
        k = _randn(gen, b, s, hkv, hd, dtype=torch.bfloat16)
        v = _randn(gen, b, s, hkv, hd, dtype=torch.bfloat16)
        want = flash_ref(q, k, v, chunk=64)
        _refuse_plain(monkeypatch, flash_ops, "flash_ref")
        out, lse = flash_ops.flash_fwd(q, k, v)
        err = float((out - want[0]).abs().max()) / float(
            want[0].abs().max())
        assert err <= 1e-5, err
        torch.testing.assert_close(lse, want[1], rtol=1e-5, atol=1e-5)

    def test_wgmma_form_issues_hgmma(self, cuda):
        flash_ops.flash_fwd(*(torch.zeros((1, 8, 1, 64), device="cuda",
                                          dtype=torch.bfloat16),) * 3)
        assert flash_ops.LIB.sass_count("HGMMA") > 0

    @pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                           (torch.float32, 2e-5)])
    @pytest.mark.parametrize("s,h,hd,hd_v", [(2048, 16, 192, 128),
                                             (333, 4, 48, 32),
                                             (17, 2, 40, 40)])
    def test_padded_widths_equal_plain_version(self, cuda, monkeypatch, s,
                                               h, hd, hd_v, dtype, tol):
        """Widths the kernel has no form for (MLA's prefill: q and k 192,
        v 128, scale 1/sqrt(192)) run zero-padded to the next form (256)
        and cut back."""
        b = 2 if s < 2048 else 1
        gen = _gen(hd * s + h)
        q = _randn(gen, b, s, h, hd, dtype=dtype)
        k = _randn(gen, b, s, h, hd, dtype=dtype)
        v = _randn(gen, b, s, h, hd_v, dtype=dtype)
        scale = 1.0 / hd ** 0.5
        want = flash_ref(q, k, v, chunk=64, scale=scale)
        _refuse_plain(monkeypatch, flash_ops, "flash_ref")
        before = flash_ops.LAUNCHER.launches
        out, lse = flash_ops.flash_fwd(q, k, v, scale=scale)
        torch.cuda.synchronize()
        assert flash_ops.LAUNCHER.launches == before + 1
        assert out.shape == (b, h, s, hd_v)
        torch.testing.assert_close(out, want[0], rtol=tol, atol=tol)
        torch.testing.assert_close(lse, want[1], rtol=tol, atol=tol)

    def test_refused_launches_raise(self, cuda):
        q = torch.zeros((1, 16, 4, 288), device="cuda")
        k = torch.zeros((1, 16, 2, 288), device="cuda")
        before = flash_ops.LAUNCHER.launches
        with pytest.raises(ValueError, match="head_dim"):
            flash_ops.flash_fwd(q, k, k)
        q = torch.zeros((1, 16, 4, 64), device="cuda")
        k = torch.zeros((1, 16, 2, 64), device="cuda")
        with pytest.raises(TypeError, match="dtype"):
            flash_ops.flash_fwd(q, k.to(torch.bfloat16), k)
        with pytest.raises(ValueError, match="KV heads"):
            flash_ops.flash_fwd(q, torch.zeros((1, 16, 3, 64),
                                               device="cuda"), k)
        assert flash_ops.LAUNCHER.launches == before

    def test_cpu_tensors_take_the_plain_version(self, cuda):
        q = torch.randn(1, 24, 2, 32)
        k = torch.randn(1, 24, 1, 32)
        before = flash_ops.LAUNCHER.launches
        out, _ = flash_ops.flash_fwd(q, k, k)
        assert out.device.type == "cpu"
        assert flash_ops.LAUNCHER.launches == before
        flash_ops.flash_fwd(q.cuda(), k.cuda(), k.cuda())
        assert flash_ops.LAUNCHER.launches == before + 1


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


class TestSsdIntraKernel:
    """`ssd_intra` against its plain version: on the card within 2e-5 of
    max |output| (float32 sums in other orders), and `cum` against the
    plain version on the CPU bit for bit (both accumulate the float
    products in double)."""

    @staticmethod
    def _inputs(gen, bt, nc, q, nh, hd, n, a=None):
        x = _randn(gen, bt, nc, q, nh, hd)
        dt = torch.nn.functional.softplus(_randn(gen, bt, nc, q, nh))
        A = (torch.full((nh,), a, device="cuda") if a is not None else
             -torch.exp(0.3 * _randn(gen, nh)))     # each head its own A
        return (x, dt, A, _randn(gen, bt, nc, q, n), _randn(gen, bt, nc, q, n))

    @pytest.mark.parametrize("bt,nc,q,nh,hd,n,a", [
        (4, 8, 256, 32, 64, 128, None),     # mamba2-370m's prefill
        (4, 8, 256, 64, 64, 64, None),      # zamba2-1.2b's prefill
        (2, 2, 256, 8, 64, 128, -1.0),      # exp overflows unless masked
        (2, 2, 16, 2, 16, 16, None), (2, 2, 32, 4, 32, 16, None),
        (2, 2, 64, 2, 64, 32, None),        # test_kernels.py's sets
        (1, 3, 100, 9, 32, 16, None),       # ragged row tile and head group
        (1, 2, 128, 5, 128, 128, None), (3, 1, 1, 1, 16, 64, None)])
    def test_equals_plain_version(self, cuda, monkeypatch, bt, nc, q, nh, hd,
                                  n, a):
        ins = self._inputs(_gen(q * nh + hd), bt, nc, q, nh, hd, n, a)
        want = ssd_ref.intra_chunk_ref(*ins)
        cpu_cum = ssd_ref.intra_chunk_ref(*(t.cpu() for t in ins))[2]
        _refuse_plain(monkeypatch, ssd_ops, "intra_chunk_ref")
        before = ssd_ops.LAUNCHER.launches
        got = ssd_ops.ssd_intra(*ins)
        torch.cuda.synchronize()
        assert ssd_ops.LAUNCHER.launches == before + 1
        for name, g, w in zip(("y", "states", "cum"), got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert bool(torch.isfinite(g).all()), name
            tol = 2e-5 * float(w.abs().max())
            torch.testing.assert_close(g, w, rtol=0.0, atol=tol, msg=name)
        assert torch.equal(got[2].cpu(), cpu_cum)

    @pytest.mark.parametrize("q", (1, 17, 64, 256))
    @pytest.mark.parametrize("n", (16, 64, 128))
    @pytest.mark.parametrize("hd", (16, 64, 128))
    def test_tensor_core_tiles_cover_every_shape(self, cuda, monkeypatch, hd,
                                                 n, q):
        """The 3xTF32 tiles over head and state widths, chunks off the
        64-row tile and the 8-row fragment, and head counts off the
        8-head group: within 2e-5 of max |output| of the plain version."""
        nh = 5 if q % 2 else 9
        ins = self._inputs(_gen(hd * n + q), 1, 2, q, nh, hd, n)
        want = ssd_ref.intra_chunk_ref(*ins)
        _refuse_plain(monkeypatch, ssd_ops, "intra_chunk_ref")
        got = ssd_ops.ssd_intra(*ins)
        torch.cuda.synchronize()
        for name, g, w in zip(("y", "states", "cum"), got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert bool(torch.isfinite(g).all()), name
            tol = 2e-5 * float(w.abs().max())
            torch.testing.assert_close(g, w, rtol=0.0, atol=tol, msg=name)

    def test_unaligned_inputs_are_copied_aligned(self, cuda, monkeypatch):
        """Inputs whose rows do not start 16-byte aligned (views at an
        offset of one float) are copied by the wrapper into fresh buffers
        for the kernel's 16-byte copies, to the same result within 2e-5 of
        max |output|; the C entry itself refuses them (-5)."""
        ins = self._inputs(_gen(7), 1, 2, 100, 9, 64, 32)

        def shifted(t):
            buf = torch.empty(t.numel() + 1, device="cuda")
            view = buf[1:].view(t.shape)
            view.copy_(t)
            return view

        x, dt, A, B, C = ins
        moved = (shifted(x), dt, A, shifted(B), shifted(C))
        assert moved[0].data_ptr() % 16 and moved[0].is_contiguous()
        want = ssd_ref.intra_chunk_ref(*ins)
        _refuse_plain(monkeypatch, ssd_ops, "intra_chunk_ref")
        got = ssd_ops.ssd_intra(*moved)
        torch.cuda.synchronize()
        for name, g, w in zip(("y", "states", "cum"), got, want):
            tol = 2e-5 * float(w.abs().max())
            torch.testing.assert_close(g, w, rtol=0.0, atol=tol, msg=name)
        y, states, cum = (torch.empty_like(t) for t in got)
        rc = ssd_ops.LIB.load().ssd_intra(
            moved[0].data_ptr(), dt.data_ptr(), A.data_ptr(),
            moved[3].data_ptr(), moved[4].data_ptr(), y.data_ptr(),
            states.data_ptr(), cum.data_ptr(), 2, 100, 9, 64, 32,
            torch.cuda.current_stream().cuda_stream)
        assert rc == -5

    def test_issues_hmma(self, cuda):
        """The products run on the tensor cores (mma.sync, TF32)."""
        ssd_ops.ssd_intra(*self._inputs(_gen(4), 1, 1, 16, 1, 16, 16))
        assert ssd_ops.LIB.sass_count("HMMA") > 0

    def test_refused_launches_raise(self, cuda):
        x, dt, A, B, C = self._inputs(_gen(1), 1, 2, 32, 4, 64, 32)
        before = ssd_ops.LAUNCHER.launches
        with pytest.raises(ValueError, match="head_dim"):
            ssd_ops.ssd_intra(x[..., :48].contiguous(), dt, A, B, C)
        with pytest.raises(ValueError, match="d_state"):
            ssd_ops.ssd_intra(x, dt, A, B[..., :24].contiguous(),
                              C[..., :24].contiguous())
        with pytest.raises(TypeError, match="dtype"):
            ssd_ops.ssd_intra(x.to(torch.bfloat16), dt, A, B, C)
        with pytest.raises(ValueError, match="contiguous"):
            ssd_ops.ssd_intra(x, dt, A, B.transpose(2, 3).contiguous()
                              .transpose(2, 3), C)
        with pytest.raises(ValueError, match="chunk"):
            big = self._inputs(_gen(2), 1, 1, 512, 1, 16, 16)
            ssd_ops.ssd_intra(*big)
        assert ssd_ops.LAUNCHER.launches == before

    def test_a_missing_library_raises(self, cuda, monkeypatch, tmp_path):
        """No built library and no nvcc: the wrapper raises; it does not
        take the plain version."""
        from repro_torch.kernels import _build

        def no_nvcc():
            raise RuntimeError("nvcc not found")

        monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
        monkeypatch.setattr(_build, "nvcc", no_nvcc)
        monkeypatch.setattr(ssd_ops.LIB, "_lib", None)
        _refuse_plain(monkeypatch, ssd_ops, "intra_chunk_ref")
        before = ssd_ops.LAUNCHER.launches
        with pytest.raises(RuntimeError, match="nvcc not found"):
            ssd_ops.ssd_intra(*self._inputs(_gen(3), 1, 1, 32, 2, 16, 16))
        assert ssd_ops.LAUNCHER.launches == before

    def test_cpu_tensors_take_the_plain_version(self, cuda):
        ins = self._inputs(_gen(4), 1, 2, 32, 2, 32, 16)
        before = ssd_ops.LAUNCHER.launches
        cpu = ssd_ops.ssd_intra(*(t.cpu() for t in ins))
        assert cpu[0].device.type == "cpu"
        assert ssd_ops.LAUNCHER.launches == before
        ssd_ops.ssd_intra(*ins)
        assert ssd_ops.LAUNCHER.launches == before + 1


class TestLatentDecodeKernel:
    """The latent form (MLA's absorbed decode over the int4 latent): its
    partials within 2e-5 of max |output| of the plain version's, as
    `chip_smoke.py` holds it."""

    @staticmethod
    def _tier(gen, b, s, h, r, p, group, extra=64, exact=True):
        c4, sc = quantize_rows_ref(_randn(gen, b * s, r, scale=2.0), group)
        # q bf16-exact, as the serving path forms it, or float32 that is
        # not (the kernel's second and third q terms)
        q_dt = torch.bfloat16 if exact else torch.float32
        q_lat = _randn(gen, b, h, r, dtype=q_dt).float()
        q_rope = _randn(gen, b, h, p, dtype=q_dt).float()
        krope = _randn(gen, b, s + extra, p, dtype=torch.bfloat16)
        return (q_lat, q_rope, c4.reshape(b, s, r // 2),
                sc.reshape(b, s, r // group).to(torch.bfloat16), krope)

    @staticmethod
    def _close(got, want, label):
        for name, a, w in zip(("m", "l", "acc"), got, want):
            bound = 2e-5 * max(float(w.abs().max()), 1e-30)
            err = float((a - w).abs().max())
            assert err <= bound, f"{label} {name}: {err} > {bound}"

    @pytest.mark.parametrize("dense_len", (0, 1, 15, 17, 255, 1536, 2048))
    @pytest.mark.parametrize("b", (1, 4))
    def test_deepseek_shape_equals_plain_version(self, cuda, monkeypatch, b,
                                                 dense_len):
        """B 1 and 4, H 16, r 512, p 64, group 64 over a 3200-token tier
        (deepseek-v2-lite's decode)."""
        tier = self._tier(_gen(b * 7 + dense_len), b, 3200, 16, 512, 64, 64)
        scale = 1.0 / 192 ** 0.5
        want = latent_tier_partial_ref(*tier, dense_len, 64, scale)
        _refuse_plain(monkeypatch, tiered_ops, "latent_tier_partial_ref")
        before = tiered_ops.LATENT_LAUNCHER.launches
        got = tiered_ops.latent_tier_partial(*tier, dense_len, group=64,
                                             scale=scale)
        torch.cuda.synchronize()
        assert tiered_ops.LATENT_LAUNCHER.launches == before + 1
        self._close(got, want, f"B {b} dense_len {dense_len}")
        if dense_len == 0:
            assert bool((got[0] == -1e30).all()) and bool((got[1] == 0).all())
            assert bool((got[2] == 0).all())

    @pytest.mark.parametrize("b,s,h,r,p,group,dense_len,exact", [
        (2, 300, 4, 128, 32, 32, 299, True), (3, 100, 3, 192, 16, 6, 77, True),
        (1, 70, 16, 64, 64, 2, 70, True), (2, 5000, 8, 256, 32, 64, 4999, True),
        (2, 40, 1, 448, 16, 64, 33, True), (2, 300, 5, 128, 32, 32, 15, True),
        (2, 300, 1, 64, 16, 64, 17, False),
        (4, 3200, 16, 512, 64, 64, 2048, False),
        (2, 600, 16, 512, 32, 16, 599, False)])
    def test_other_shapes_equal_plain_version(self, cuda, monkeypatch, b, s,
                                              h, r, p, group, dense_len,
                                              exact):
        tier = self._tier(_gen(r + p + h), b, s, h, r, p, group, exact=exact)
        want = latent_tier_partial_ref(*tier, dense_len, group, 0.125)
        _refuse_plain(monkeypatch, tiered_ops, "latent_tier_partial_ref")
        got = tiered_ops.latent_tier_partial(*tier, dense_len, group=group,
                                             scale=0.125)
        torch.cuda.synchronize()
        self._close(got, want, f"r {r} p {p} H {h}")

    @pytest.mark.parametrize("b,s,h,r,p,group,dense_len,exact", [
        (2, 300, 4, 32, 16, 16, 0, True), (2, 300, 4, 32, 16, 16, 1, True),
        (2, 300, 4, 32, 16, 16, 65, True),
        (4, 3200, 4, 32, 16, 16, 2048, True),
        (2, 200, 16, 32, 64, 32, 199, False),
        (1, 90, 5, 32, 32, 2, 90, False),
        (2, 300, 16, 96, 32, 32, 257, True),
        (2, 300, 8, 480, 64, 32, 299, False)])
    def test_ranks_of_32_equal_plain_version(self, cuda, monkeypatch, b, s,
                                             h, r, p, group, dense_len,
                                             exact):
        """r 32 (deepseek-v2-lite reduced: H 4, p 16, the serving tests'
        group 16), whose one warp of latent features is 32 wide, and
        other odd multiples of 32 (a last warp 32 wide beside 64-wide
        ones)."""
        tier = self._tier(_gen(r + p + h + dense_len), b, s, h, r, p, group,
                          exact=exact)
        want = latent_tier_partial_ref(*tier, dense_len, group, 0.125)
        _refuse_plain(monkeypatch, tiered_ops, "latent_tier_partial_ref")
        before = tiered_ops.LATENT_LAUNCHER.launches
        got = tiered_ops.latent_tier_partial(*tier, dense_len, group=group,
                                             scale=0.125)
        torch.cuda.synchronize()
        assert tiered_ops.LATENT_LAUNCHER.launches == before + 1
        self._close(got, want, f"r {r} p {p} H {h} dense_len {dense_len}")

    def test_refused_launches_raise(self, cuda):
        tier = self._tier(_gen(3), 1, 64, 4, 128, 32, 32)
        before = tiered_ops.LATENT_LAUNCHER.launches
        with pytest.raises(ValueError, match="dense_len"):
            tiered_ops.latent_tier_partial(*tier, 65, group=32)
        with pytest.raises(ValueError, match="rank"):
            tiered_ops.latent_tier_partial(
                tier[0][..., :80].contiguous(), tier[1],
                tier[2][..., :40].contiguous(),
                tier[3][..., :2].contiguous(), tier[4], 8, group=32)
        with pytest.raises(ValueError, match="heads"):
            tiered_ops.latent_tier_partial(
                torch.zeros((1, 17, 128), device="cuda"),
                torch.zeros((1, 17, 32), device="cuda"), *tier[2:], 8,
                group=32)
        with pytest.raises(TypeError, match="c4_sc"):
            tiered_ops.latent_tier_partial(*tier[:3], tier[3].float(),
                                           tier[4], 8, group=32)
        assert tiered_ops.LATENT_LAUNCHER.launches == before

    def test_cpu_tensors_take_the_plain_version(self, cuda):
        tier = self._tier(_gen(4), 1, 64, 4, 128, 32, 32)
        before = tiered_ops.LATENT_LAUNCHER.launches
        cpu = tiered_ops.latent_tier_partial(*(t.cpu() for t in tier), 20,
                                             group=32)
        assert cpu[0].device.type == "cpu"
        assert tiered_ops.LATENT_LAUNCHER.launches == before
        tiered_ops.latent_tier_partial(*tier, 20, group=32)
        assert tiered_ops.LATENT_LAUNCHER.launches == before + 1


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@contextlib.contextmanager
def _routes(log, replay):
    """Record the port's MoE routes (the card run) or replay them (the
    CPU run): a near-tie that rounds the other way on the CPU would move
    the logits for no fault of a kernel."""
    from repro_torch.models import moe
    orig = moe._routing
    it = iter(list(log))

    def route(router_w, x, m):
        w, e, aux = orig(router_w, x, m)
        if replay:
            rw, re = next(it)
            return rw.to(w.device), re.to(e.device), aux
        log.append((w.cpu(), e.cpu()))
        return w, e, aux

    moe._routing = route
    try:
        yield
    finally:
        moe._routing = orig


def _serve_on_both(cfg, prompt, steps, policy):
    """`cfg` served on the card through the kernels and on the CPU through
    their plain versions, from the same weights and prompts, the CPU
    teacher-forced on the card's tokens. Returns the two runs and the
    card's kernel launches."""
    from repro_torch.core.tiercache.manager import zero_metrics
    from repro_torch.models.model_zoo import build_model, make_train_batch
    from repro_torch.serve.engine import make_serve_step, make_tier_spec
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(1))
    # tokens, and a VLM's patches or an encoder-decoder's frames
    batch = make_train_batch(cfg, 2, prompt, torch.Generator().manual_seed(0))
    prefix = cfg.vlm.num_patches if cfg.vlm is not None else 0
    launchers = {"ssd_intra": ssd_ops.LAUNCHER,
                 "flash_fwd": flash_ops.LAUNCHER,
                 "tiered_decode": tiered_ops.LAUNCHER,
                 "latent_decode": tiered_ops.LATENT_LAUNCHER,
                 "ips_repack": repack_ops.LAUNCHER}
    runs, launches, routes = {}, None, []
    for dev in ("cuda", "cpu"):
        before = {k: v.launches for k, v in launchers.items()}
        bundle = build_model(cfg, device=dev)
        spec = make_tier_spec(bundle, prefix + prompt + steps, policy,
                              hot_window=16, page_tokens=8, group=16)
        p = _to(params, dev)
        with _routes(routes, replay=dev == "cpu"):
            cache, logits = bundle.prefill(p, _to(batch, dev), spec)
            step = make_serve_step(bundle, spec, policy)
            metrics = zero_metrics()
            token = torch.argmax(logits, -1).to(torch.int32)[:, None]
            forced = runs["cuda"]["inputs"] if runs else None
            inputs, seq = [], [logits.cpu()]
            for i in range(steps):
                tok = forced[i].to(dev) if forced else token
                inputs.append(tok.cpu())
                token, lg, cache, metrics = step(p, cache, tok, metrics)
                seq.append(lg.cpu())
        runs[dev] = {"inputs": inputs, "logits": seq, "cache": cache,
                     "metrics": metrics}
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = {k: v.launches - before[k]
                        for k, v in launchers.items()}
    for a, w in zip(runs["cuda"]["logits"], runs["cpu"]["logits"]):
        torch.testing.assert_close(a, w, rtol=2e-2, atol=2e-2)
    for key in ("dense_len", "total_len"):
        assert runs["cuda"]["cache"][key] == runs["cpu"]["cache"][key]
    for k, v in runs["cpu"]["metrics"].items():
        assert runs["cuda"]["metrics"][k] == v, k
    return runs, launches


def test_serving_path_on_the_card(cuda):
    """gemma-2b reduced to two layers, served on the card through the
    three kernels and on the CPU through their plain versions, from the
    same weights and prompts, the CPU teacher-forced on the card's
    tokens: logits within 2e-2 (bf16 activations), the watermarks and
    metrics equal."""
    from repro_torch.configs import get_arch
    from repro_torch.core.tiercache.policy import Policy
    cfg = get_arch("gemma-2b").reduced(num_layers=2)
    for policy in Policy:
        _serve_on_both(cfg, 24, 40, policy)


@pytest.mark.parametrize("arch,layers", [("mamba2-370m", 2),
                                         ("zamba2-1.2b", 5)])
def test_mamba2_serving_paths_on_the_card(cuda, arch, layers):
    """mamba2-370m and zamba2 (with its tail) reduced, served on the card
    and on the CPU as above, under each policy: logits within 2e-2, the
    counters equal, and the prefill launching `ssd_intra` once per Mamba2
    layer (zamba2's shared block: flash once per macro block)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.tiercache.policy import Policy
    from repro_torch.models.hybrid import hybrid_structure
    cfg = get_arch(arch).reduced(num_layers=layers)
    for policy in Policy:
        _, launches = _serve_on_both(cfg, 64, 40, policy)
        assert launches["ssd_intra"] == layers
        if cfg.family == "ssm":
            assert launches["flash_fwd"] == launches["tiered_decode"] == 0
        else:
            n_macro, _ = hybrid_structure(cfg)
            assert launches["flash_fwd"] == n_macro
            assert launches["tiered_decode"] == n_macro * 40


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "arctic-480b"])
def test_moe_serving_paths_on_the_card(cuda, arch):
    """deepseek-v2-lite (MLA over the int4 latent: the latent form at the
    reduced config's rank 32) and arctic (GQA with
    the dense residual) reduced, served on the card and on the CPU as
    above under each policy, the CPU's MoE routes replayed from the
    card's: logits within 2e-2, the counters equal; flash once a layer a
    prefill, the attention kernel once a layer a step."""
    from repro_torch.configs import get_arch
    from repro_torch.core.tiercache.policy import Policy
    cfg = get_arch(arch).reduced()
    for policy in Policy:
        _, launches = _serve_on_both(cfg, 24, 40, policy)
        assert launches["flash_fwd"] == cfg.num_layers
        kernel = "latent_decode" if cfg.mla is not None else "tiered_decode"
        other = "tiered_decode" if cfg.mla is not None else "latent_decode"
        assert launches[kernel] == cfg.num_layers * 40
        assert launches[other] == 0


@pytest.mark.parametrize("arch", ["whisper-tiny", "llava-next-34b"])
def test_encdec_and_vlm_serving_paths_on_the_card(cuda, arch):
    """whisper-tiny (the encoder-decoder: the decoder's self-attention
    over its tiers, the cross-attention as the dense partial over the
    static cross tier) and llava-next-34b (the patch prefix) reduced,
    served on the card and on the CPU as above under each policy: logits
    within 2e-2, the counters equal; flash once a decoder layer a
    prefill, the tiered kernel once a layer a step (twice for the
    encoder-decoder: its self and cross tiers), the repack's prefill fill
    plus, for the encoder-decoder, one launch for the cross tier."""
    from repro_torch.configs import get_arch
    from repro_torch.core.tiercache.policy import Policy
    cfg = get_arch(arch).reduced()
    per_step = 2 if cfg.encdec is not None else 1
    for policy in Policy:
        runs, launches = _serve_on_both(cfg, 24, 40, policy)
        assert launches["flash_fwd"] == cfg.num_layers
        assert launches["tiered_decode"] == per_step * cfg.num_layers * 40
        assert launches["latent_decode"] == launches["ssd_intra"] == 0
        if cfg.encdec is not None:
            cache = runs["cuda"]["cache"]["layers"]
            want = runs["cpu"]["cache"]["layers"]
            for k in ("ck4", "ck4_sc", "cv4", "cv4_sc"):
                # quantized from the card's own projections: bf16 drift
                # may move a few nibbles, not the tier
                assert (cache[k].cpu() == want[k]).float().mean() > 0.9, k


# ---------------------------------------------------------------------------
# training: the kernels under autograd, and the raw wrappers' refusal
# ---------------------------------------------------------------------------


def _raw_grad_calls():
    """Each raw serving wrapper called on card tensors, one of which
    requires a gradient."""
    def f(*shape, grad=False, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="cuda",
                           requires_grad=grad)

    def u8(*shape):
        return torch.zeros(shape, dtype=torch.uint8, device="cuda")
    return {
        "flash_fwd": lambda: flash_ops.flash_fwd(
            f(1, 64, 2, 64, grad=True, dtype=torch.bfloat16),
            f(1, 64, 1, 64, dtype=torch.bfloat16),
            f(1, 64, 1, 64, dtype=torch.bfloat16)),
        "ssd_intra": lambda: ssd_ops.ssd_intra(
            f(1, 1, 16, 2, 16, grad=True), f(1, 1, 16, 2), f(2),
            f(1, 1, 16, 16), f(1, 1, 16, 16)),
        "tiered_decode": lambda: tiered_ops.dense_tier_partial(
            f(1, 1, 2, 64, grad=True), u8(1, 64, 1, 32), f(1, 64, 1, 1),
            u8(1, 64, 1, 32), f(1, 64, 1, 1), 64),
        "latent_decode": lambda: tiered_ops.latent_tier_partial(
            f(1, 2, 64, grad=True), f(1, 2, 16), u8(1, 64, 32),
            f(1, 64, 1, dtype=torch.bfloat16),
            f(1, 64, 16, dtype=torch.bfloat16), 64),
        "ips_repack": lambda: repack_ops.quantize_rows(f(4, 64, grad=True)),
    }


class TestTrainingOnTheCard:
    @pytest.mark.parametrize("name", list(_raw_grad_calls()))
    def test_raw_wrapper_refuses_grad(self, cuda, name):
        """A raw wrapper on card tensors that require a gradient raises
        instead of cutting the gradient; nothing is launched."""
        launchers = {"flash_fwd": flash_ops.LAUNCHER,
                     "ssd_intra": ssd_ops.LAUNCHER,
                     "tiered_decode": tiered_ops.LAUNCHER,
                     "latent_decode": tiered_ops.LATENT_LAUNCHER,
                     "ips_repack": repack_ops.LAUNCHER}
        before = launchers[name].launches
        with pytest.raises(RuntimeError, match="require a gradient"):
            _raw_grad_calls()[name]()
        assert launchers[name].launches == before

    def test_flash_function_grads_equal_plain_version(self, cuda,
                                                      monkeypatch):
        """gemma-2b's served prefill shape (B 4, S 2048, H 8, Hkv 1, hd
        256, bf16): (dq, dk, dv) with the kernel's forward against the
        same Function with the plain forward, within 1e-2 of the largest
        gradient (bf16, as the serving path's check holds the kernel)."""
        b, s, h, hkv, hd = 4, 2048, 8, 1, 256
        gen = _gen(11)
        inputs = [_randn(gen, b, s, n, hd, dtype=torch.bfloat16)
                  for n in (h, hkv, hkv)]
        w = _randn(gen, b, h, s, hd)

        def grads():
            ts = [t.clone().requires_grad_(True) for t in inputs]
            out, _ = flash_ops.flash_attention(*ts, chunk=512)
            return torch.autograd.grad((out * w).sum(), ts)
        before = flash_ops.LAUNCHER.launches
        got = grads()
        torch.cuda.synchronize()
        assert flash_ops.LAUNCHER.launches == before + 1
        monkeypatch.setattr(flash_ops, "flash_fwd", flash_ref)
        want = grads()
        for name, g, r in zip("qkv", got, want):
            assert torch.isfinite(g).all(), name
            scale = float(r.float().abs().max())
            torch.testing.assert_close(g.float(), r.float(), rtol=0,
                                       atol=1e-2 * scale)

    def test_ssd_intra_function_grads_equal_plain_version(self, cuda,
                                                          monkeypatch):
        """mamba2-370m's served shape (B 4, S 2048, 32 heads of 64, N 128,
        chunk 256): every input's gradient through the chunked scan with
        the kernel's forward against the plain forward, within 2e-5 of
        the largest (the path check's bar)."""
        b, s, nh, hd, n, q = 4, 2048, 32, 64, 128, 256
        gen = _gen(12)
        x = _randn(gen, b, s, nh, hd)
        dt = 0.05 + 0.5 * torch.rand((b, s, nh), generator=gen,
                                     device="cuda")
        a = -(0.5 + torch.rand((nh,), generator=gen, device="cuda"))
        bb, c = _randn(gen, b, s, n), _randn(gen, b, s, n)
        wy, wh = _randn(gen, b, s, nh, hd), _randn(gen, b, nh, hd, n)

        def grads():
            ts = [t.clone().requires_grad_(True) for t in (x, dt, a, bb, c)]
            y, hf = ssd_ops.ssd_chunked_kernel(*ts, q)
            return torch.autograd.grad((y * wy).sum() + (hf * wh).sum(), ts)
        before = ssd_ops.LAUNCHER.launches
        got = grads()
        torch.cuda.synchronize()
        assert ssd_ops.LAUNCHER.launches == before + 1
        monkeypatch.setattr(ssd_ops, "ssd_intra", ssd_ref.intra_chunk_ref)
        want = grads()
        for name, g, r in zip(("x", "dt", "A", "B", "C"), got, want):
            assert torch.isfinite(g).all(), name
            torch.testing.assert_close(g, r, rtol=0, atol=2e-5 * float(
                r.abs().max()))


# ---------------------------------------------------------------------------
# distribution: ranks spawned as processes that share the card
# ---------------------------------------------------------------------------

from repro_torch.distributed import group as dist_group  # noqa: E402

import torch_dist_util as dist_util  # noqa: E402


class TestDistributedOnTheCard:
    def test_ranks_sharing_the_card(self, cuda, tmp_path):
        """2 gloo ranks on the one card: compressed_psum within 1e-6 of
        the one-process computation, the residual equal; a state sharded
        under (data 2, model 1), saved and restored, every piece on the
        card equal to its slice; the quick grid's slice one launch a
        rank, every cell equal to one process's run on the card."""
        from repro_torch.configs.ssd_paper import PAPER_SSD as cfg0
        from repro_torch.sweep.grid import named_grid
        from repro_torch.sweep.runner import run_sweep
        from repro_torch.workloads import TraceCache
        ssd_step.LIB.build()
        got = dist_group.spawn(dist_util.card_ranks, 2, str(tmp_path), 2048,
                               device="cuda")
        want = run_sweep(cfg0.scaled(128), named_grid("quick"),
                         max_ops=2048, device=cuda,
                         trace_cache=TraceCache(use_disk=False))
        for r in got:
            assert r["psum_err"] <= 1e-6 and r["residual_equal"]
            assert r["pieces_equal"]
            assert r["launches"] == 1
            assert r["sweep"] == {pt.key: v for pt, v in want.items()}

    def test_one_rank_nccl_group(self, cuda):
        """compressed_psum over a 1-rank NCCL group: the one-process
        answer, to the bit."""
        got = dist_group.spawn(dist_util.card_nccl, 1, device="cuda")[0]
        assert got["backend"] == "nccl"
        assert got["out_equal"] and got["err_equal"]


# ---------------------------------------------------------------------------
# the dev scripts on the card
# ---------------------------------------------------------------------------


def test_smoke_models_on_the_card(cuda, capsys):
    """`scripts/smoke_models_torch.py` over every arch, reduced, on the
    card (its default): each arch passes with its family's kernels
    launched — `flash_fwd` with attention, `tiered_decode` for the `gqa`
    and `encdec_self` kinds, the latent form at the reduced deepseek's
    rank 32, `ssd_intra` for mamba2 and zamba2."""
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "smoke_models_torch", os.path.join(root, "scripts",
                                           "smoke_models_torch.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.main([]) == 0
    out = capsys.readouterr().out
    assert out.rstrip().endswith("failures: none")
    assert out.count("OK   ") == len(smoke.ARCHS)
    assert "'latent_decode'" in out and "'ssd_intra'" in out
