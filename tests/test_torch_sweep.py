"""Port vs reference: the sweep runner and the CLI.

`sweep.runner.run_sweep` groups points into (composition, mode, length,
wear) fleets exactly as the reference's runner does and must return the
same per-cell metrics (counters, WA and the lifetime columns exact, mean
latency and the two bucket means within rtol 1e-6), on the paper grid's
kinds of cell and on every grid this slice adds. The CLI writes only its
own `BENCH_torch_*` artifact; the report functions equal the
reference's on one results dict, `bootstrap_ci`'s draws included.
"""
import json
import os

import numpy as np
import pytest

import repro.workloads as jwl
from repro.sweep import report as jreport
from repro.sweep.grid import SweepPoint as JPoint
from repro.sweep.grid import named_grid as j_named_grid
from repro.sweep.runner import run_sweep as j_run_sweep
from repro_torch import workloads as twl
from repro_torch.sweep import cli as tcli
from repro_torch.sweep import report as treport
from repro_torch.sweep.grid import SweepPoint as TPoint
from repro_torch.sweep.grid import named_grid as t_named_grid
from repro_torch.sweep.runner import run_sweep as t_run_sweep
from test_torch_fleet import assert_metrics_match
from torch_port_util import CFG_J, CFG_T, reference_registry


SWEEP_POINTS = (
    dict(trace="hm_0", mode="daily", policy="baseline"),
    dict(trace="hm_0", mode="daily", policy="ips_agc"),
    dict(trace="hm_0", mode="daily", policy="baseline", cache_frac=0.5),
    dict(trace="hm_0", mode="daily", policy="ips_agc", cache_frac=0.5),
    dict(trace="proj_0", mode="bursty", policy="baseline"),
    dict(trace="proj_0", mode="bursty", policy="coop"),
    dict(trace="hm_1", mode="bursty", policy="coop", repeat=2),
)


def test_run_sweep_matches_reference():
    j_res = j_run_sweep(CFG_J, [JPoint(**p) for p in SWEEP_POINTS],
                        max_ops=512,
                        trace_cache=jwl.TraceCache(use_disk=False))
    timings = []
    t_res = t_run_sweep(CFG_T, [TPoint(**p) for p in SWEEP_POINTS],
                        max_ops=512, device="cpu", timings=timings,
                        trace_cache=twl.TraceCache(use_disk=False))
    j_by_key = {pt.key: v for pt, v in j_res.items()}
    assert sorted(pt.key for pt in t_res) == sorted(j_by_key)
    for pt, got in t_res.items():
        ref = j_by_key[pt.key]
        assert got["n_ops"] == ref["n_ops"]
        assert_metrics_match(ref, got, pt.key)
    # one group per (composition, mode, padded length)
    assert len(timings) == 4
    assert sum(g["cells"] for g in timings) == len(SWEEP_POINTS)
    assert all(g["kernel_ms"] is None and g["ops_per_s"] > 0
               for g in timings)


def test_cli_writes_its_own_artifact(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE_DIR", str(tmp_path / "tc"))
    assert tcli.main(["--grid", "quick", "--device", "cpu", "--max-ops",
                      "96", "--out-dir", str(tmp_path)]) == 0
    files = sorted(p.name for p in tmp_path.iterdir() if p.is_file())
    # the sweep's artifact, and the run's record in the port's history
    # (with its append lock), as the reference's CLI keeps its own
    assert files == ["BENCH_torch_history.json",
                     "BENCH_torch_history.json.lock",
                     "BENCH_torch_sweep_quick.json"]
    doc = json.loads((tmp_path / "BENCH_torch_sweep_quick.json").read_text())
    assert doc["n_cells"] == len(doc["results"]) == 8
    assert set(doc["geomeans"]) == {"bursty/ips", "daily/ips"}
    assert doc["meta"]["device"] == "cpu"
    assert "geomeans vs declared baseline" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the stress, mixed, endurance and sensitivity grids, the CLI's workload
# and wear flags, the report functions
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEAR_EXACT = ("eff_cycles_max", "tbw_proj_gb", "eol_op", "pe_slc_total",
              "pe_rp_total", "pe_tlc_total", "pe_trad_total", "erase_events")
# float32 means over buckets: summed in float64 by the port
WEAR_CLOSE = ("eff_cycles_mean", "cycle_skew")


def assert_cell_matches(ref: dict, got: dict, label: str) -> None:
    """Counters and WA exact, mean latency within rtol 1e-6; the wear
    columns exact but the two bucket means (rtol 1e-6)."""
    assert got["n_ops"] == ref["n_ops"], label
    assert_metrics_match(ref, got, label)
    assert set(got) == set(ref), f"{label}: keys"
    for key in WEAR_EXACT:
        if key in ref:
            assert got[key] == ref[key], f"{label}: {key}"
    for key in WEAR_CLOSE:
        if key in ref:
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-6,
                                       err_msg=f"{label}: {key}")


@pytest.mark.parametrize("grid,max_ops", (("stress", 160), ("mixed", 160),
                                          ("endurance", 160),
                                          ("sensitivity", 160)))
def test_new_grids_match_reference(grid, max_ops):
    """`run_sweep` on each grid this slice adds equals the reference's
    cell for cell at the same `max_ops` (endurance cells step every op)."""
    with reference_registry():
        j_res = j_run_sweep(CFG_J, j_named_grid(grid), max_ops=max_ops,
                            trace_cache=jwl.TraceCache(use_disk=False))
    timings = []
    t_res = t_run_sweep(CFG_T, t_named_grid(grid), max_ops=max_ops,
                        device="cpu", timings=timings,
                        trace_cache=twl.TraceCache(use_disk=False))
    j_by_key = {pt.key: v for pt, v in j_res.items()}
    assert sorted(pt.key for pt in t_res) == sorted(j_by_key)
    for pt, got in t_res.items():
        assert_cell_matches(j_by_key[pt.key], got, pt.key)
    # groups that track wear step every padded op
    assert all(g["t_scan"] == g["t_len"] for g in timings if g["endurance"])
    assert any(g["endurance"] for g in timings) == (grid in ("endurance",
                                                             "sensitivity"))


def test_cli_trace_file_and_listings(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE_DIR", str(tmp_path / "tc"))
    sample = os.path.join(ROOT, "tests", "data", "sample_msr.csv")
    assert tcli.main(["--trace-file", sample, "--policies", "baseline,ips",
                      "--modes", "daily", "--device", "cpu", "--max-ops",
                      "256", "--out-dir", str(tmp_path), "--name",
                      "file"]) == 0
    doc = json.loads((tmp_path / "BENCH_torch_file.json").read_text())
    assert sorted(doc["results"]) == [f"{sample}/daily/baseline",
                                      f"{sample}/daily/ips"]
    assert doc["trace_cache"]["misses"] >= 1
    assert tcli.main(["--list-grids"]) == 0
    out = capsys.readouterr().out
    for grid in ("paper", "matrix", "stress", "mixed", "endurance",
                 "sensitivity", "hostcache"):
        assert grid in out
    assert tcli.main(["--list-policies"]) == 0
    assert "ips_raro" in capsys.readouterr().out
    # orphaned baselines, unknown specs and bad knobs are refused
    assert tcli.main(["--traces", "hm_0", "--policies", "ips_raro",
                      "--device", "cpu", "--no-save"]) == 2
    assert tcli.main(["--traces", "nope", "--device", "cpu",
                      "--no-save"]) == 2
    assert tcli.main(["--traces", "hm_0", "--endurance", "w_rp=x",
                      "--device", "cpu", "--no-save"]) == 2
    assert "w_rp" in capsys.readouterr().err
    # the host tier is ported: its grid builds, a bad knob is refused
    assert len(t_named_grid("hostcache")) == 40
    assert tcli.main(["--traces", "hm_0", "--hostcache", "mode=xx",
                      "--device", "cpu", "--no-save"]) == 2
    assert "--hostcache" in capsys.readouterr().err


def test_cli_endurance_flag_and_tables(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE_DIR", str(tmp_path / "tc"))
    assert tcli.main(["--traces", "hm_0", "--policies",
                      "baseline,ips,ips_raro",
                      "--modes", "daily", "--endurance",
                      "w_rp=4,rp_budget=2", "--device", "cpu",
                      "--max-ops", "96", "--seeds", "0,1", "--out-dir",
                      str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "endurance: lifetime" in out and "bootstrap CI" in out
    doc = json.loads(
        (tmp_path / "BENCH_torch_sweep_custom.json").read_text())
    assert set(doc["endurance"]) == {"daily/baseline", "daily/ips",
                                     "daily/ips_raro"}
    assert "geomeans_ci" in doc
    assert all("endur=rp2:w4:b30000" in k for k in doc["results"])


def _reference_results(grid):
    """SweepPoint-keyed results of the reference's uncut run of `grid`,
    for both packages' points."""
    if grid == "endurance":
        with open(os.path.join(ROOT, "BENCH_sweep_endurance.json")) as f:
            by_key = json.load(f)["results"]
    else:
        with open(os.path.join(ROOT, "tests", "data",
                               "torch_reference_sweeps.json")) as f:
            by_key = json.load(f)["grids"][grid]["results"]
    with reference_registry():
        j_points = j_named_grid(grid)
    return ({p: by_key[p.key] for p in j_points},
            {p: by_key[p.key] for p in t_named_grid(grid)})


def test_report_functions_match_reference():
    j_res, t_res = _reference_results("endurance")
    assert treport.endurance_summary(t_res) == \
        jreport.endurance_summary(j_res)
    assert treport.policy_geomeans(t_res) == jreport.policy_geomeans(j_res)
    j_res, t_res = _reference_results("sensitivity")
    with reference_registry():
        j_deltas = jreport.sensitivity_deltas(j_res)
    assert treport.sensitivity_deltas(t_res) == j_deltas
    j_res, t_res = _reference_results("mixed")
    assert treport.policy_geomeans_ci(t_res) == \
        jreport.policy_geomeans_ci(j_res)
    # bootstrap_ci draws what the reference draws, seed for seed
    vals = np.random.default_rng(5).uniform(0.2, 3.0, 17)
    for seed in (0, 1, 7):
        for n_boot in (10, 1000):
            assert treport.bootstrap_ci(vals, n_boot=n_boot, seed=seed) == \
                jreport.bootstrap_ci(vals, n_boot=n_boot, seed=seed)
    assert np.isnan(treport.bootstrap_ci([])[0])
