"""The pass route of the port's host tier — the tier pass over whole
traces (`kernels/host_tier`, its plain version on the CPU), the sub-op
streams through `ssd_step.run_streams`, the assembly
(`hostcache.pipeline`) — as `fleet.run_fleets` runs it, against the
reference's `run_fleet`, live JAX: every mode x promote x flush in both
access modes (`torch_port_util.HOST_CASES`), fleets of two cells
(flush_burst and hm_1, 512 ops daily and 256 bursty), every group of an access mode in ONE call beside
a device-only group, the telemetry probe on. Latencies, every leaf of the
final states (host windows and timelines included) and the summaries
equal the reference's, as in `test_torch_hostcache_modes.py`.
"""
import numpy as np
import pytest
import torch

from torch_port_util import (CFG_J, CFG_T, HOST_CASES, HOST_WINDOW,
                             N_LOGICAL, assert_leaf_equal,
                             assert_state_equal, host_case_id, host_trace)
from test_torch_hostcache_modes import assert_summaries_equal

from repro.core.ssd import fleet as jfleet
from repro.core.ssd import sim as jsim
from repro.hostcache.model import H_CTR
from repro.hostcache.model import as_hc_params as j_as_hc
from repro.hostcache.spec import HostCacheSpec as JSpec
from repro_torch.core.ssd import fleet as tfleet
from repro_torch.core.ssd import sim as tsim
from repro_torch.core.ssd.policies.state import map_state
from repro_torch.hostcache.model import as_hc_params
from repro_torch.hostcache.spec import HostCacheSpec
from repro_torch.kernels.host_tier import ops as host_tier

TRACES = ("flush_burst", "hm_1")
FLEET_OPS = {"daily": 512, "bursty": 256}


def _traces(access):
    return [host_trace(name, access, FLEET_OPS[access]) for name in TRACES]


@pytest.fixture(scope="module", params=("daily", "bursty"))
def port_runs(request):
    """Every case's fleet of an access mode, and a device-only fleet, in
    one `run_fleets` call."""
    access = request.param
    ops = tfleet.stack_ops(_traces(access), device="cpu")
    groups = []
    for kw, policy in HOST_CASES:
        spec = HostCacheSpec(**kw)
        p = tsim.default_params(CFG_T, policy, device="cpu")._replace(
            hostcache=as_hc_params(spec, "cpu"))
        groups.append(tfleet.FleetGroup(
            policy, ops, map_state(lambda x: torch.stack([x, x]), p),
            access == "bursty", hostcache=spec))
    off = tfleet.FleetGroup(
        "ips", ops, map_state(lambda x: torch.stack([x, x]),
                              tsim.default_params(CFG_T, "ips",
                                                  device="cpu")),
        access == "bursty")
    runs = tfleet.run_fleets(CFG_T, groups + [off], n_logical=N_LOGICAL,
                             timeline_ops=HOST_WINDOW)
    return access, runs


@pytest.mark.parametrize("i", range(len(HOST_CASES)),
                         ids=[host_case_id(c) for c in HOST_CASES])
def test_pass_route_matches_reference_fleet(port_runs, i):
    access, runs = port_runs
    kw, policy = HOST_CASES[i]
    hc = JSpec(**kw)
    traces = _traces(access)
    p = jsim.default_params(CFG_J, policy)._replace(hostcache=j_as_hc(hc))
    j_lat, j_st = jfleet.run_fleet(
        CFG_J, policy, jfleet.stack_ops(traces), jfleet.stack_params([p, p]),
        closed_loop=access == "bursty", n_logical=N_LOGICAL,
        timeline_ops=HOST_WINDOW, hostcache=hc)
    t_lat, t_st = runs[i]
    label = f"{host_case_id(HOST_CASES[i])}/{access}"
    assert_leaf_equal(j_lat, t_lat, f"{label}: latency")
    assert_state_equal(j_st, t_st, label)
    isw = np.stack([np.asarray(t["is_write"]) for t in traces])
    assert_summaries_equal(jfleet.summarize_fleet(j_lat, isw, j_st),
                           tfleet.summarize_fleet(t_lat, isw, t_st), label)


def test_cases_fire_every_counter(port_runs):
    """Across the cases every host counter moves: hits, absorption,
    pass-throughs, flush bursts and write-backs (the idle-gap flush in
    daily replay only: closed loop switches it off)."""
    access, runs = port_runs
    tot = sum(st.hostcache.hctr.sum(0) for _, st in runs[:-1])
    for name, i in H_CTR.items():
        if access == "bursty" and name in ("hits", "read_hits",
                                           "write_hits"):
            continue        # the sequential rewrite never reuses an lba
        assert float(tot[i]) > 0, name
    idle = [st.hostcache.hctr[:, H_CTR["flush_w"]].sum()
            for (kw, _), (_, st) in zip(HOST_CASES, runs)
            if kw["mode"] == "wb" and kw["flush"] == "idle"]
    assert (sum(idle) > 0) == (access == "daily")


def test_the_cpu_runs_the_plain_version_without_a_launch():
    """The tier pass takes a whole call's host groups as one job list:
    on the CPU its plain version runs them job by job, and the launch
    count stays 0 (the CPU never launches a kernel)."""
    host_tier.reset()
    ops = tfleet.stack_ops(_traces("daily")[:1], device="cpu")
    spec = HostCacheSpec(sets=8, ways=2)
    p = tsim.default_params(CFG_T, "ips", device="cpu")._replace(
        hostcache=as_hc_params(spec, "cpu"))
    tfleet.run_fleet(CFG_T, "ips", {k: v[:, :64] for k, v in ops.items()},
                     map_state(lambda x: x[None], p), closed_loop=False,
                     n_logical=N_LOGICAL, hostcache=spec)
    assert host_tier.launches == 0
