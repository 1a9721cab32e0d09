"""The port's search engine (`repro_torch.search`) against the reference's
(`repro.search`), live JAX on the CPU: the candidate spaces and their
groups, successive halving at the `smoke` schedule (survivors, front,
rounds; scores within rtol 1e-6, the mean latency's bar), the scenario
search's history, the kernel-specialisation count that stands in for the
reference's compile count (zero for a knob-only round), and the CLI's
`--search`.

The tuner and scenario runs use a drive scaled down to 1/2048 (4 SLC
pages a plane): a few hundred ops then fill its cache, so the
candidates' scores differ and the pruning is not decided by ties alone.
"""
import contextlib
import dataclasses
import json

import pytest

from torch_port_util import reference_registry

from repro.configs.ssd_paper import PAPER_SSD as J_PAPER_SSD
from repro.search import scenario as jscenario
from repro.search import space as jspace
from repro.search import tune as jtune
from repro_torch.configs.ssd_paper import PAPER_SSD as T_PAPER_SSD
from repro_torch.kernels.ssd_step import ops as ssd_step
from repro_torch.search import scenario as tscenario
from repro_torch.search import space as tspace
from repro_torch.search import tune as ttune

SCALE = 2048
CFG_J, CFG_T = J_PAPER_SSD.scaled(SCALE), T_PAPER_SSD.scaled(SCALE)
MAX_OPS = 384


@contextlib.contextmanager
def port_registry():
    """The port's policy registry restored after the block: the `full`
    space registers the unnamed compositions, which must not leak into
    another test file's registry in the same worker."""
    from repro_torch.core.ssd.policies import registry
    saved = dict(registry._REGISTRY)
    try:
        yield
    finally:
        registry._REGISTRY.clear()
        registry._REGISTRY.update(saved)


def _group_id(key):
    spec, hc = key
    return (dataclasses.astuple(spec), None if hc is None else hc.tag)


@pytest.mark.parametrize("budget", ("smoke", "quick", "full"))
def test_space_and_groups_match_reference(budget):
    with reference_registry(), port_registry():
        j, t = jspace.build_space(budget), tspace.build_space(budget)
        assert [c.to_json() for c in j] == [c.to_json() for c in t]
        jg, tg = jspace.group_candidates(j), tspace.group_candidates(t)
        assert [_group_id(k) for k in jg] == [_group_id(k) for k in tg]
        assert [[c.label for c in v] for v in jg.values()] == \
            [[c.label for c in v] for v in tg.values()]
        assert [c.point("hm_0", "daily").key for c in j] == \
            [c.point("hm_0", "daily").key for c in t]


def test_schedules_and_spaces_are_the_reference_s():
    assert ttune.SCHEDULES == jtune.SCHEDULES
    assert tspace.SPACES == jspace.SPACES
    assert tscenario.DEFAULT_SCEN_OPS == jscenario.DEFAULT_SCEN_OPS


def _smoke_rounds():
    return [dict(r, max_ops=MAX_OPS)
            for r in jtune.SCHEDULES["smoke"]["rounds"]]


@pytest.fixture(scope="module")
def halving():
    sched = jtune.SCHEDULES["smoke"]
    kw = dict(seed=0, keep_frac=sched["keep_frac"],
              min_keep=sched["min_keep"])
    with reference_registry():
        j = jtune.successive_halving(CFG_J, jspace.build_space("smoke"),
                                     _smoke_rounds(),
                                     cell_bucket=sched["cell_bucket"], **kw)
    t = ttune.successive_halving(CFG_T, tspace.build_space("smoke"),
                                 _smoke_rounds(), device="cpu", **kw)
    return j, t


def _close(a, b):
    if a is None or b is None:
        return a is None and b is None
    return a == pytest.approx(b, rel=1e-6)


def test_halving_matches_reference(halving):
    j, t = halving
    assert [c.label for c in t.survivors] == [c.label for c in j.survivors]
    assert [c.label for c, _ in t.front] == [c.label for c, _ in j.front]
    for jr, tr in zip(j.round_scores, t.round_scores):
        assert [c.label for c in tr] == [c.label for c in jr]
        for (jc, js), (tc, ts) in zip(jr.items(), tr.items()):
            assert js["n"] == ts["n"], jc.label
            for m in ("lat", "waf", "tbw"):
                assert _close(ts[m], js[m]), (jc.label, m)
    keys = ("round", "traces", "modes", "max_ops", "candidates",
            "survivors", "cells", "groups", "best")
    assert [{k: r[k] for k in keys} for r in t.rounds] == \
        [{k: r[k] for k in keys} for r in j.rounds]
    # the scores tell the candidates apart: not all ties at 1.0
    assert len({round(s["lat"], 6) for s in t.scores.values()}) > 1


def test_knob_only_round_adds_no_specialisation(monkeypatch):
    """A second round over the same compositions and modes — other knob
    values, another workload budget — needs no kernel specialisation the
    first did not: the reference's "knob-only rounds compile nothing"
    contract, on the port's count. The count starts empty, as in a fresh
    process: other test files in the same worker may have needed a
    specialisation this test counts as new."""
    monkeypatch.setattr(ssd_step, "_SPECIALISATIONS", set())
    cands = [tspace.Candidate("ips"), tspace.Candidate("ips", cache_frac=0.5),
             tspace.Candidate("coop")]
    rounds = [{"traces": ("hm_0",), "modes": ("daily",), "max_ops": 128},
              {"traces": ("hm_0", "hm_1"), "modes": ("daily",),
               "max_ops": 160}]
    res = ttune.successive_halving(CFG_T, cands, rounds, keep_frac=1.0,
                                   min_keep=3, device="cpu")
    assert res.rounds[1]["compiles"] == 0
    before = ssd_step.specialisations()
    ttune.evaluate_candidates(
        CFG_T, [tspace.Candidate("ips", cache_frac=2.0),
                tspace.Candidate("coop", idle_threshold_ms=2.0)],
        traces=("hm_1",), modes=("daily",), max_ops=96, device="cpu")
    assert ssd_step.specialisations() == before
    # a new mode is new work
    ttune.evaluate_candidates(CFG_T, cands[:1], traces=("hm_0",),
                              modes=("bursty",), max_ops=64, device="cpu")
    assert ssd_step.specialisations() > before


def test_separation_search_matches_reference():
    kw = dict(seed=3, iters=1, pop=2, max_ops=MAX_OPS)
    j = jscenario.separation_search(CFG_J, "ips", "baseline", **kw)
    t = tscenario.separation_search(CFG_T, "ips", "baseline", device="cpu",
                                    **kw)
    assert t["history"] == j["history"]
    assert t["best_stats"] == j["best_stats"]
    assert t["flipped"] == j["flipped"]
    assert _close(t["best_ratio"], j["best_ratio"])
    assert _close(t["msr_geomean"], j["msr_geomean"])
    assert set(t["msr_ratios"]) == set(j["msr_ratios"])
    for name, v in j["msr_ratios"].items():
        assert _close(t["msr_ratios"][name], v), name
    assert {k: v for k, v in t.items() if "ratio" not in k
            and k not in ("history", "best_stats", "msr_geomean")} == \
        {k: v for k, v in j.items() if "ratio" not in k
         and k not in ("history", "best_stats", "msr_geomean")}


def test_cli_search_writes_the_port_s_artifact(tmp_path):
    from repro_torch.sweep.cli import main
    rc = main(["--search", "smoke", "--max-ops", "96", "--device", "cpu",
               "--scale", str(SCALE), "--out-dir", str(tmp_path),
               "--no-trace-cache-disk"])
    assert rc == 0
    assert not (tmp_path / "BENCH_search.json").exists()
    doc = json.loads((tmp_path / "BENCH_torch_search.json").read_text())
    assert doc["front"] and doc["rounds"] and doc["scenario_search"]["history"]
    for r in doc["rounds"]:
        assert {"survivors", "compiles", "cells", "groups",
                "wall_s"} <= set(r)
    assert doc["device"] == "cpu" and "specialisations" in doc
    hist = json.loads((tmp_path / "BENCH_torch_history.json").read_text())
    assert hist["records"][-1]["kind"] == "search"


def test_cli_search_refuses_sweep_selectors(capsys):
    from repro_torch.sweep.cli import main
    assert main(["--search", "smoke", "--grid", "quick",
                 "--device", "cpu"]) == 2
    assert "--search" in capsys.readouterr().err
    assert main(["--grid", "quick", "--search-scenario", "ips:coop",
                 "--device", "cpu"]) == 2
