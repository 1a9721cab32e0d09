"""Port vs reference: the evaluation matrix and its benchmarks.

* `sweep.runner.run_matrix` and `core.ssd.driver.eval_matrix` return the
  reference's keys in the reference's order and its values: counters
  exact, mean latency within rtol 1e-6 (at a cut `max_ops`; the
  reference's `eval_matrix` takes none, so both packages' `run_matrix`
  are cut the same way underneath it).
* `report.normalize_to_baseline` equals the reference's on one results
  dict, qualified keys included.
* `store.check_step_throughput` and `store.check_hostcache_sweep` accept
  the reference's committed documents and the port's own, and reject
  the same malformed documents as the reference's checks.
* `runner.bench_fleet_vs_loop` on one cell (the loop is `eval_cell`, the
  plain version an op at a time on the CPU, so the trace is cut), the
  CLI's `--bench`, and `scripts/bench_step_torch.py` at a tiny size.
"""
import copy
import functools
import importlib.util
import json
import os

import numpy as np
import pytest

import repro.sweep.runner as jrunner
import repro.workloads as jwl
from repro.core.ssd import driver as jdriver
from repro.sweep import report as jreport
from repro.sweep import store as jstore
from repro_torch import sweep as tsweep
from repro_torch import workloads as twl
from repro_torch.core.ssd import driver as tdriver
from repro_torch.sweep import cli as tcli
from repro_torch.sweep import runner as trunner
from repro_torch.sweep import store as tstore
from test_torch_fleet import assert_metrics_match
from torch_port_util import CFG_J, CFG_T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("hm_0", "proj_0")
MAX_OPS = 96


def _load(name):
    with open(os.path.join(ROOT, name)) as f:
        return json.load(f)


def _assert_matrix_equal(ref: dict, got: dict) -> None:
    assert list(got) == list(ref)
    for key, want in ref.items():
        assert set(got[key]) == set(want), key
        assert got[key]["n_ops"] == want["n_ops"], key
        assert_metrics_match(want, got[key], key)


def test_run_matrix_matches_reference():
    kw = dict(policies=("baseline", "ips", "ips_agc"),
              modes=("bursty", "daily"), names=NAMES, max_ops=MAX_OPS)
    ref = jrunner.run_matrix(CFG_J, **kw,
                             trace_cache=jwl.TraceCache(use_disk=False))
    got = trunner.run_matrix(CFG_T, **kw, device="cpu",
                             trace_cache=twl.TraceCache(use_disk=False))
    assert len(got) == 12
    _assert_matrix_equal(ref, got)


def test_eval_matrix_is_run_matrix_in_the_reference_order(monkeypatch):
    """Both packages' `eval_matrix` over their own `run_matrix`, each cut
    to MAX_OPS ops underneath: same keys, same order, same values."""
    monkeypatch.setattr(jrunner, "run_matrix", functools.partial(
        jrunner.run_matrix, max_ops=MAX_OPS))
    monkeypatch.setattr(trunner, "run_matrix", functools.partial(
        trunner.run_matrix, max_ops=MAX_OPS))
    kw = dict(policies=["ips_agc", "coop"], modes=["daily"], names=NAMES,
              seed=1)
    ref = jdriver.eval_matrix(CFG_J, **kw)
    got = tdriver.eval_matrix(CFG_T, **kw, device="cpu")
    assert sorted(got) == ["hm_0/daily/coop", "hm_0/daily/ips_agc",
                           "proj_0/daily/coop", "proj_0/daily/ips_agc"]
    _assert_matrix_equal(ref, got)


def test_sweep_exports_match_the_reference():
    import repro.sweep as jsweep
    for name in jsweep.__all__:
        assert callable(getattr(tsweep, name)) or name == "GRIDS", name
    for name in ("check_step_throughput", "check_hostcache_sweep"):
        assert getattr(tsweep, name) is getattr(tstore, name)
    assert tsweep.bench_fleet_vs_loop is trunner.bench_fleet_vs_loop
    assert tdriver.eval_matrix.__module__ == "repro_torch.core.ssd.driver"


def test_normalize_to_baseline_matches_reference():
    res = {"hm_0/daily/baseline": {"m": 2.0},
           "hm_0/daily/ips": {"m": 1.0},
           "hm_0/daily/baseline&cf=0.5": {"m": 4.0},
           "hm_0/daily/ips_agc&cf=0.5": {"m": 1.0},
           "hm_0/bursty/ips": {"m": 3.0},          # no baseline: skipped
           "proj_0/daily/baseline": {"m": 0.0},    # clamped divisor
           "proj_0/daily/coop": {"m": 5e-13}}
    want = jreport.normalize_to_baseline(res, "m")
    got = tsweep.normalize_to_baseline(res, "m")
    assert got == want
    assert got["hm_0/daily/ips_agc&cf=0.5"] == 0.25
    assert "hm_0/bursty/ips" not in got
    paper = _load("BENCH_sweep_paper.json")["results"]
    assert any("&" in k for k in paper)
    for metric in ("mean_write_latency_ms", "wa_paper"):
        assert (tsweep.normalize_to_baseline(paper, metric)
                == jreport.normalize_to_baseline(paper, metric))


# ---------------------------------------------------------------------------
# the store's checks
# ---------------------------------------------------------------------------

CHECKS = (jstore, tstore)


def _bench_step_module():
    spec = importlib.util.spec_from_file_location(
        "bench_step_torch", os.path.join(ROOT, "scripts",
                                         "bench_step_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port_step_doc(tmp_path_factory):
    """The port's own step-throughput document, at a tiny size."""
    out = tmp_path_factory.mktemp("bench_step")
    assert _bench_step_module().main(
        ["--device", "cpu", "--traces", "hm_0,proj_0", "--max-ops", "64",
         "--out-dir", str(out)]) == 0
    names = sorted(p.name for p in out.iterdir() if p.is_file())
    assert names == ["BENCH_torch_history.json",
                     "BENCH_torch_history.json.lock",
                     "BENCH_torch_step_throughput.json"]
    doc = json.loads((out / "BENCH_torch_step_throughput.json").read_text())
    hist = json.loads((out / "BENCH_torch_history.json").read_text())
    assert [r["kind"] for r in hist["records"]] == ["bench_step"]
    return doc


def test_bench_step_torch_passes_both_checks(port_step_doc):
    doc = port_step_doc
    assert doc["name"] == "torch_step_throughput"
    assert doc["meta"]["device"] == "cpu" and doc["device"] == "cpu"
    assert set(doc["traces"]) == {"hm_0", "proj_0"}
    for row in doc["traces"].values():
        # ops/s credit the padded length the truncation leaves
        assert row["t_len"] == 64
        assert row["per_op"]["ops_per_s"] == pytest.approx(
            64 / row["per_op"]["warm_s"], rel=1e-3)
    for store in CHECKS:
        assert store.check_step_throughput(doc) is doc


@pytest.mark.parametrize("store", CHECKS, ids=("reference", "port"))
def test_step_check_accepts_the_committed_document(store):
    doc = _load("BENCH_step_throughput.json")
    assert store.check_step_throughput(doc, min_speedup=3.0) is doc


def _drop(path):
    def edit(doc):
        *head, last = path
        node = doc
        for k in head:
            node = node[k]
        del node[last]
    return edit


def _set(path, value):
    def edit(doc):
        *head, last = path
        node = doc
        for k in head:
            node = node[k]
        node[last] = value
    return edit


def _first(doc, key):
    return next(iter(doc[key]))


STEP_FAULTS = {
    "no meta": _drop(("meta",)),
    "no policy": _set(("policy",), ""),
    "no traces": _set(("traces",), {}),
    "row without fill": lambda d: d["traces"][_first(d, "traces")].pop(
        "fill"),
    "zero warm time": lambda d: d["traces"][_first(d, "traces")][
        "packed"].update(warm_s=0.0),
    "zero speedup": lambda d: d["traces"][_first(d, "traces")].update(
        speedup_compressed=0.0),
    "no packed geomean": _drop(("geomean_speedup", "packed")),
}


@pytest.mark.parametrize("fault", sorted(STEP_FAULTS))
@pytest.mark.parametrize("store", CHECKS, ids=("reference", "port"))
def test_step_check_rejects_malformed_documents(store, fault,
                                                port_step_doc):
    for doc in (_load("BENCH_step_throughput.json"), port_step_doc):
        bad = copy.deepcopy(doc)
        STEP_FAULTS[fault](bad)
        with pytest.raises(AssertionError):
            store.check_step_throughput(bad)


@pytest.mark.parametrize("store", CHECKS, ids=("reference", "port"))
def test_step_check_gates_the_speedup(store, port_step_doc):
    doc = copy.deepcopy(port_step_doc)
    doc["geomean_speedup"]["compressed"] = 1.5
    assert store.check_step_throughput(doc, min_speedup=1.5) is doc
    with pytest.raises(AssertionError, match="step throughput gate"):
        store.check_step_throughput(doc, min_speedup=3.0)


@pytest.fixture(scope="module")
def port_hostcache_doc(tmp_path_factory):
    """The port's own `hostcache` grid document: the CLI on the CPU, its
    traces cut to a few hundred ops."""
    out = tmp_path_factory.mktemp("hostcache")
    old = os.environ.get("REPRO_TORCH_TRACE_CACHE_DIR")
    os.environ["REPRO_TORCH_TRACE_CACHE_DIR"] = str(out / "tc")
    try:
        assert tcli.main(["--grid", "hostcache", "--device", "cpu",
                          "--max-ops", "256", "--out-dir", str(out),
                          "--no-history"]) == 0
    finally:
        if old is None:
            del os.environ["REPRO_TORCH_TRACE_CACHE_DIR"]
        else:
            os.environ["REPRO_TORCH_TRACE_CACHE_DIR"] = old
    return json.loads((out / "BENCH_torch_sweep_hostcache.json").read_text())


@pytest.mark.parametrize("store", CHECKS, ids=("reference", "port"))
def test_hostcache_check_accepts_both_documents(store, port_hostcache_doc):
    for doc in (_load("BENCH_sweep_hostcache.json"), port_hostcache_doc):
        assert store.check_hostcache_sweep(doc) is doc


def _wb_daily(doc):
    return next(k for k in doc["hostcache"]
                if "/wb" in k and k.startswith("daily/"))


HOSTCACHE_FAULTS = {
    "no results": _set(("results",), {}),
    "no host cells": lambda d: d.update(results={
        k: v for k, v in d["results"].items() if "hc=" not in k}),
    "no device-only cells": lambda d: d.update(results={
        k: v for k, v in d["results"].items() if "hc=" in k}),
    "host cell without its columns": lambda d: next(
        v for k, v in d["results"].items() if "hc=" in k).pop(
        "host_hit_rate"),
    "device-only cell with host columns": lambda d: next(
        v for k, v in d["results"].items() if "hc=" not in k).update(
        host_hit_rate=0.0),
    "no summary": _drop(("hostcache",)),
    "summary without lat_vs_off": lambda d: d["hostcache"][
        _first(d, "hostcache")].pop("lat_vs_off"),
    "unpaired summary row": lambda d: d["hostcache"][
        _first(d, "hostcache")].update(lat_vs_off=None),
    "write-back absorbing nothing": lambda d: d["hostcache"][
        _wb_daily(d)].update(host_dev_write_frac=1.0),
    "daily write-back never hitting": lambda d: d["hostcache"][
        _wb_daily(d)].update(host_hit_rate=0.0),
}


@pytest.mark.parametrize("fault", sorted(HOSTCACHE_FAULTS))
@pytest.mark.parametrize("store", CHECKS, ids=("reference", "port"))
def test_hostcache_check_rejects_malformed_documents(store, fault,
                                                     port_hostcache_doc):
    for doc in (_load("BENCH_sweep_hostcache.json"), port_hostcache_doc):
        bad = copy.deepcopy(doc)
        HOSTCACHE_FAULTS[fault](bad)
        with pytest.raises(AssertionError):
            store.check_hostcache_sweep(bad)


# ---------------------------------------------------------------------------
# the fleet against the loop
# ---------------------------------------------------------------------------


def test_bench_fleet_vs_loop_on_one_cell():
    seen = []
    bench = trunner.bench_fleet_vs_loop(
        CFG_T, policies=("ips_agc",), modes=("daily",), names=("hm_0",),
        progress=seen.append, max_ops=256, device="cpu")
    assert seen == ["loop hm_0/daily/ips_agc"]
    assert bench["n_cells"] == 1
    assert bench["max_rel_diff"] == 0.0
    assert bench["loop_wall_s"] > 0 and bench["fleet_wall_s"] > 0
    assert bench["speedup"] > 0
    # the fleet's memory-only cache: the one trace built once, no disk
    assert bench["trace_cache"]["dir"] is None
    assert bench["trace_cache"]["misses"] == 1
    ref = jrunner.run_matrix(CFG_J, policies=("ips_agc",), modes=("daily",),
                             names=("hm_0",), max_ops=256,
                             trace_cache=jwl.TraceCache(use_disk=False))
    _assert_matrix_equal(ref, bench["results"])
    json.dumps({k: v for k, v in bench.items() if k != "results"})


def test_eval_cell_equals_the_fleet_cell():
    got = tdriver.eval_cell(CFG_T, "proj_0", "coop", "bursty", max_ops=128,
                            device="cpu")
    ref = jrunner.run_matrix(CFG_J, policies=("coop",), modes=("bursty",),
                             names=("proj_0",), max_ops=128,
                             trace_cache=jwl.TraceCache(use_disk=False))
    want = ref["proj_0/bursty/coop"]
    assert got["n_ops"] == want["n_ops"]
    assert_metrics_match(want, got, "eval_cell")
    assert np.isfinite(got["mean_write_latency_ms"])


def test_cli_bench_writes_only_the_ports_artifacts(tmp_path, capsys,
                                                   monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE_DIR", str(tmp_path / "tc"))
    monkeypatch.chdir(tmp_path)
    assert tcli.main(["--traces", "hm_0", "--policies", "baseline,ips",
                      "--modes", "daily", "--device", "cpu", "--max-ops",
                      "32", "--bench", "--out-dir", str(tmp_path)]) == 0
    files = sorted(p.name for p in tmp_path.iterdir() if p.is_file())
    assert files == ["BENCH_torch_history.json",
                     "BENCH_torch_history.json.lock",
                     "BENCH_torch_sweep_custom.json"]
    out = capsys.readouterr().out
    assert "benchmark: fleet vs looped eval_cell (full matrix)" in out
    assert "speedup" in out and "max rel diff 0.00e+00" in out
    doc = json.loads((tmp_path / "BENCH_torch_sweep_custom.json").read_text())
    bench = doc["fleet_vs_loop"]
    assert "results" not in bench
    assert bench["n_cells"] == 66 and bench["max_rel_diff"] == 0.0
    assert bench["names"] == list(twl.TRACE_NAMES)


def test_cli_refuses_bench_with_search(capsys):
    assert tcli.main(["--search", "smoke", "--device", "cpu",
                      "--bench"]) == 2
    assert "--bench" in capsys.readouterr().err
