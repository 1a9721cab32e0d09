"""Port vs reference: the fleet path and its summaries.

* `fleet.run_fleet(trim_pads=True, packed=True)` on a 4-cell fleet —
  the shared live prefix scanned, every cell's pad tail replayed to its
  exact fixed point — equals the live JAX `run_fleet`, leaf for leaf.
* `fleet.run_fleets` — twelve (composition, mode, length) groups in one
  call, as the sweep runner makes it — equals `run_fleet` group by group
  and the live JAX `run_fleet`, leaf for leaf.
* `flush_fleet` + `summarize_fleet`: counters and write amplification
  exact; `mean_write_latency_ms` within rtol 1e-6 (the port sums the
  float32 latencies in float64 and rounds once, the reference sums in
  float32 in its own order).
"""
import numpy as np
import pytest
import torch

from repro.core.ssd import fleet as jfleet
from repro.core.ssd import sim as jsim
from repro_torch.core.ssd import fleet as tfleet
from repro_torch.core.ssd import sim as tsim
from torch_port_util import (CFG_J, CFG_T, N_LOGICAL, assert_leaf_equal,
                             assert_state_equal, fixture_ops)

FLEET_TRACES = ("hm_0", "proj_0", "hm_1", "stg_0")
EXACT = ("wa_paper", "wa_raw", "slc_writes", "tlc_writes", "reprogram_host",
         "reprogram_agc", "reprogram_trad", "migrations", "erases",
         "host_pages", "conflict_ms")


def assert_metrics_match(ref: dict, got: dict, label: str) -> None:
    for key in EXACT:
        assert got[key] == ref[key], f"{label}: {key} {got[key]} != {ref[key]}"
    np.testing.assert_allclose(got["mean_write_latency_ms"],
                               ref["mean_write_latency_ms"], rtol=1e-6,
                               err_msg=f"{label}: mean_write_latency_ms")


@pytest.fixture(scope="module")
def fleet_runs():
    """baseline/daily — the migrate mechanism drains above-watermark
    planes pad by pad, so the tail replay is load-bearing — on 1024 live
    ops per cell, padded to 16384: 8192 ops scanned, 8192 replayed."""
    traces = [fixture_ops(t, max_ops=1024, n_pad=16384 - 1024)
              for t in FLEET_TRACES]
    policy = "baseline"
    j_params = jfleet.stack_params(
        [jsim.default_params(CFG_J, policy, 0.05)] * len(traces))
    j_ops = jfleet.stack_ops(traces)
    j_lat, j_state = jfleet.run_fleet(
        CFG_J, policy, j_ops, j_params, closed_loop=False,
        n_logical=N_LOGICAL, trim_pads=True, packed=True)
    t_params = tfleet.stack_params(
        [tsim.default_params(CFG_T, policy, 0.05, device="cpu")]
        * len(traces))
    t_ops = tfleet.stack_ops(traces, device="cpu")
    t_lat, t_state = tfleet.run_fleet(
        CFG_T, policy, t_ops, t_params, closed_loop=False,
        n_logical=N_LOGICAL, trim_pads=True, packed=True)
    return policy, (j_ops, j_lat, j_state), (t_ops, t_lat, t_state)


def test_trim_len_matches_reference(fleet_runs):
    _, (j_ops, _, _), (t_ops, _, _) = fleet_runs
    is_w = np.asarray(j_ops["is_write"])
    assert tfleet._trim_len(t_ops["is_write"].numpy()) \
        == jfleet._trim_len(is_w) == 8192


def test_trimmed_fleet_matches_reference(fleet_runs):
    _, (_, j_lat, j_state), (_, t_lat, t_state) = fleet_runs
    assert_leaf_equal(j_lat, t_lat, "fleet latency")
    assert_state_equal(j_state, t_state, "fleet")


def test_fleet_summaries_match_reference(fleet_runs):
    policy, (j_ops, j_lat, j_state), (t_ops, t_lat, t_state) = fleet_runs
    j_flushed = jfleet.flush_fleet(CFG_J, j_state, policy)
    t_flushed = tfleet.flush_fleet(CFG_T, t_state, policy)
    assert_leaf_equal(j_flushed.counters, t_flushed.counters,
                      "flushed counters")
    j_summ = jfleet.summarize_fleet(j_lat, j_ops["is_write"], j_flushed)
    t_summ = tfleet.summarize_fleet(t_lat, t_ops["is_write"], t_flushed)
    assert set(t_summ) == set(j_summ)
    for c, name in enumerate(FLEET_TRACES):
        assert_metrics_match({k: float(v[c]) for k, v in j_summ.items()},
                             {k: float(v[c]) for k, v in t_summ.items()},
                             name)


def test_single_cell_summarize_matches_reference():
    ops = fixture_ops("proj_0", max_ops=512, n_pad=0)
    j_lat, j_state = jsim.run_trace(CFG_J, "ips_agc", ops, closed_loop=False,
                                    n_logical=N_LOGICAL, waste_p=0.1)
    t_lat, t_state = tsim.run_trace(CFG_T, "ips_agc", ops, closed_loop=False,
                                    n_logical=N_LOGICAL, waste_p=0.1,
                                    device="cpu")
    j_summ = jsim.summarize(j_lat, {"is_write": ops["is_write"]},
                            jsim.flush_cache(CFG_J, j_state, "ips_agc"))
    t_summ = tsim.summarize(t_lat, ops["is_write"],
                            tsim.flush_cache(CFG_T, t_state, "ips_agc"))
    assert_metrics_match({k: float(v) for k, v in j_summ.items()},
                         {k: float(v) for k, v in t_summ.items()}, "proj_0")


# ---------------------------------------------------------------------------
# run_fleets: many (composition, mode, length) groups in one call
# ---------------------------------------------------------------------------

MIXED_POLICIES = ("baseline", "ips_agc", "coop")
MIXED_MODES = ("daily", "bursty")
# two trace lengths, the longer at the sweep's --max-ops 2048
MIXED_TRACES = (("hm_0", 2048, 256), ("proj_0", 512, 256))
MIXED_GROUPS = [(p, m, t) for p in MIXED_POLICIES for m in MIXED_MODES
                for t in MIXED_TRACES]


def _group_id(group):
    policy, mode, (name, n_ops, n_pad) = group
    return f"{policy}-{mode}-{name}-{n_ops + n_pad}"


@pytest.fixture(scope="module")
def mixed_fleets():
    """The twelve groups (baseline, ips_agc and coop x daily and bursty x
    two trace lengths), one cell each: the port's `run_fleets` over all
    of them in one call, and per group the port's `run_fleet` and the
    live JAX `run_fleet`."""
    groups, j_runs, t_single = [], [], []
    for policy, mode, (name, n_ops, n_pad) in MIXED_GROUPS:
        trace = fixture_ops(name, max_ops=n_ops, n_pad=n_pad)
        closed = mode == "bursty"
        j_params = jfleet.stack_params([jsim.default_params(CFG_J, policy,
                                                            0.05)])
        j_runs.append(jfleet.run_fleet(
            CFG_J, policy, jfleet.stack_ops([trace]), j_params,
            closed_loop=closed, n_logical=N_LOGICAL, trim_pads=True,
            packed=True))
        group = tfleet.FleetGroup(
            policy, tfleet.stack_ops([trace], device="cpu"),
            tfleet.stack_params([tsim.default_params(CFG_T, policy, 0.05,
                                                     device="cpu")]),
            closed_loop=closed, packed=True)
        groups.append(group)
        t_single.append(tfleet.run_fleet(
            CFG_T, group.policy, group.ops, group.params,
            closed_loop=closed, n_logical=N_LOGICAL, trim_pads=True,
            packed=True))
    t_all = tfleet.run_fleets(CFG_T, groups, n_logical=N_LOGICAL,
                              trim_pads=True)
    return groups, t_all, t_single, j_runs


def test_run_fleets_takes_every_group_in_one_call(mixed_fleets):
    groups, t_all, _, _ = mixed_fleets
    assert len(t_all) == len(groups) == 12
    assert len({g.ops["lba"].shape[1] for g in groups}) == 2
    for g, (lat, final) in zip(groups, t_all):
        assert lat.shape == g.ops["lba"].shape
        assert final.loc.shape == (1, N_LOGICAL)


@pytest.mark.parametrize("i", range(len(MIXED_GROUPS)),
                         ids=[_group_id(g) for g in MIXED_GROUPS])
def test_run_fleets_equals_run_fleet_group_by_group(mixed_fleets, i):
    _, t_all, t_single, _ = mixed_fleets
    (lat, final), (lat1, final1) = t_all[i], t_single[i]
    assert torch.equal(lat, lat1)
    for field in final._fields:
        got, want = getattr(final, field), getattr(final1, field)
        if want is None:
            assert got is None, field
            continue
        assert got.dtype == want.dtype and torch.equal(got, want), field


@pytest.mark.parametrize("i", range(len(MIXED_GROUPS)),
                         ids=[_group_id(g) for g in MIXED_GROUPS])
def test_run_fleets_matches_reference(mixed_fleets, i):
    _, t_all, _, j_runs = mixed_fleets
    (t_lat, t_state), (j_lat, j_state) = t_all[i], j_runs[i]
    label = _group_id(MIXED_GROUPS[i])
    assert_leaf_equal(j_lat, t_lat, f"{label}: latency")
    assert_state_equal(j_state, t_state, label)
