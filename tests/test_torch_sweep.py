"""Port vs reference: the sweep runner and the CLI.

`sweep.runner.run_sweep` groups points into (composition, mode, length)
fleets exactly as the reference's runner does and must return the same
per-cell metrics (counters and WA exact, mean latency within rtol 1e-6).
The CLI writes only its own `BENCH_torch_*` artifact.
"""
import json

import repro.workloads as jwl
from repro.sweep.grid import SweepPoint as JPoint
from repro.sweep.runner import run_sweep as j_run_sweep
from repro_torch.sweep import cli as tcli
from repro_torch.sweep.grid import SweepPoint as TPoint
from repro_torch.sweep.runner import run_sweep as t_run_sweep
from test_torch_fleet import assert_metrics_match
from torch_port_util import CFG_J, CFG_T


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
                        max_ops=512, device="cpu", timings=timings)
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


def test_cli_writes_its_own_artifact(tmp_path, capsys):
    assert tcli.main(["--grid", "quick", "--device", "cpu", "--max-ops",
                      "96", "--out-dir", str(tmp_path)]) == 0
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["BENCH_torch_sweep_quick.json"]
    doc = json.loads((tmp_path / files[0]).read_text())
    assert doc["n_cells"] == len(doc["results"]) == 8
    assert set(doc["geomeans"]) == {"bursty/ips", "daily/ips"}
    assert doc["meta"]["device"] == "cpu"
    assert "geomeans vs declared baseline" in capsys.readouterr().out
