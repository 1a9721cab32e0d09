"""The port's composed host-tier step (`hostcache.pipeline.build_tier_step`,
what `sim.run_trace` runs on the CPU) against the reference's, live JAX:
every mode x promote x flush in both access modes (the cases of
`torch_port_util.HOST_CASES`), the telemetry probe on. Every latency and
every leaf of the final state equals the reference's bit for bit — the
device carry, the host tier, the windowed timeline and the host windows,
float sums included — and so does the summary with its host-tier metrics
(the mean write latency to rtol 1e-6: the port sums it in float64).
"""
import numpy as np
import pytest

from torch_port_util import (CFG_J, CFG_T, HOST_CASES, HOST_OPS,
                             HOST_WINDOW, N_LOGICAL, assert_leaf_equal,
                             assert_state_equal, host_case_id, host_trace)

from repro.core.ssd import sim as jsim
from repro.hostcache.spec import HostCacheSpec as JSpec
from repro_torch.core.ssd import sim as tsim
from repro_torch.hostcache.spec import HostCacheSpec


def assert_summaries_equal(j_summ, t_summ, label):
    assert set(j_summ) == set(t_summ), label
    for key, want in j_summ.items():
        if key == "mean_write_latency_ms":
            np.testing.assert_allclose(t_summ[key].numpy(), np.asarray(want),
                                       rtol=1e-6, err_msg=label)
        else:
            assert_leaf_equal(want, t_summ[key], f"{label}: {key}")


@pytest.mark.parametrize("access", ("daily", "bursty"))
@pytest.mark.parametrize("case", HOST_CASES, ids=host_case_id)
def test_composed_step_matches_reference(case, access):
    kw, policy = case
    trace = host_trace("flush_burst", access, HOST_OPS[access])
    closed = access == "bursty"
    j_lat, j_st = jsim.run_trace(CFG_J, policy, trace, closed_loop=closed,
                                 n_logical=N_LOGICAL, hostcache=JSpec(**kw),
                                 timeline_ops=HOST_WINDOW)
    t_lat, t_st = tsim.run_trace(CFG_T, policy, trace, closed_loop=closed,
                                 n_logical=N_LOGICAL,
                                 hostcache=HostCacheSpec(**kw),
                                 timeline_ops=HOST_WINDOW, device="cpu")
    label = f"{host_case_id(case)}/{access}"
    assert_leaf_equal(j_lat, t_lat, f"{label}: latency")
    assert_state_equal(j_st, t_st, label)
    isw = np.asarray(trace["is_write"])
    assert_summaries_equal(
        jsim.summarize(j_lat, {"is_write": isw}, j_st),
        tsim.summarize(t_lat, isw, t_st), label)
