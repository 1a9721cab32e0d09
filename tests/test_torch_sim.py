"""Port vs reference: the single-cell per-op path (`sim.run_trace`).

Every SimState leaf and every per-op latency of the port's `run_trace`
(on the CPU: the `ssd_step` kernel's plain version, the engine's per-op
executor in a loop, then the pad tail replayed to its fixed point) must
equal the live JAX `run_trace` (a full `lax.scan` over every op, pads
included) bit for bit, dtype for dtype.
"""
import numpy as np
import pytest

from repro.core.ssd import sim as jsim
from repro_torch.core.ssd import sim as tsim
from torch_port_util import (CFG_J, CFG_T, MODES, N_LOGICAL, PAPER_POLICIES,
                             assert_leaf_equal, assert_state_equal,
                             fixture_ops)

TRACES = ("hm_0", "proj_0")
# every paper policy in both modes, each mode on one trace, alternating
# so that each policy also meets both traces
CASES = ([(p, m, TRACES[(i + j) % 2]) for i, p in enumerate(PAPER_POLICIES)
          for j, m in enumerate(MODES)]
         + [("dyn_slc", "daily", "hm_0"), ("ips_lazy", "daily", "proj_0")])


@pytest.fixture(scope="module")
def traces():
    return {t: fixture_ops(t) for t in TRACES}


@pytest.mark.parametrize("policy,mode,trace", CASES)
def test_run_trace_matches_reference(traces, policy, mode, trace):
    ops = traces[trace]
    closed = mode == "bursty"
    j_lat, j_state = jsim.run_trace(CFG_J, policy, ops, closed_loop=closed,
                                    n_logical=N_LOGICAL)
    t_lat, t_state = tsim.run_trace(CFG_T, policy, ops, closed_loop=closed,
                                    n_logical=N_LOGICAL, device="cpu")
    label = f"{trace}/{mode}/{policy}"
    assert_leaf_equal(j_lat, t_lat, f"{label}: latency")
    assert_state_equal(j_state, t_state, label)


def test_run_trace_packed_matches_reference(traces):
    ops = traces["hm_0"]
    j_lat, j_state = jsim.run_trace(CFG_J, "coop", ops, closed_loop=False,
                                    n_logical=N_LOGICAL, packed=True)
    t_lat, t_state = tsim.run_trace(CFG_T, "coop", ops, closed_loop=False,
                                    n_logical=N_LOGICAL, packed=True,
                                    device="cpu")
    assert_leaf_equal(j_lat, t_lat, "packed: latency")
    assert_state_equal(j_state, t_state, "packed")


def test_unpadded_trace_scans_every_op():
    """A trace without an `ir.pad_ops` tail (truncated mid-stream) is
    scanned op for op — no fixed-point shortcut applies."""
    ops = fixture_ops("hm_0", max_ops=512, n_pad=0)
    assert tsim.scan_len(ops) == 512
    j_lat, j_state = jsim.run_trace(CFG_J, "baseline", ops,
                                    closed_loop=False, n_logical=N_LOGICAL)
    t_lat, t_state = tsim.run_trace(CFG_T, "baseline", ops,
                                    closed_loop=False, n_logical=N_LOGICAL,
                                    device="cpu")
    assert_leaf_equal(j_lat, t_lat, "unpadded: latency")
    assert_state_equal(j_state, t_state, "unpadded")


def test_scan_len_stops_at_the_pad_tail():
    ops = fixture_ops("hm_0", max_ops=300, n_pad=100)
    assert tsim.scan_len(ops) == 300
    # a tail whose pads are not identical is not a pad_ops tail
    bad = dict(ops, lba=ops["lba"].copy())
    bad["lba"][-1] = 7
    assert tsim.scan_len(bad) == 400
    assert tsim.scan_len({k: v[:0] for k, v in ops.items()
                          if isinstance(v, np.ndarray)}) == 0


# the valid compositions without wear state that no name registers
UNNAMED = (("static", "idle_gap", "migrate", "greedy"),
           ("adaptive", "idle_gap", "migrate", "greedy"))


@pytest.mark.parametrize("axes", UNNAMED, ids=lambda a: "+".join(a))
def test_unnamed_compositions_match_reference(traces, axes):
    from repro.core.ssd.policies.spec import PolicySpec as JSpec
    from repro_torch.core.ssd.policies.spec import PolicySpec as TSpec
    ops = traces["hm_0"]
    j_lat, j_state = jsim.run_trace(CFG_J, JSpec(*axes), ops,
                                    closed_loop=False, n_logical=N_LOGICAL)
    t_lat, t_state = tsim.run_trace(CFG_T, TSpec(*axes), ops,
                                    closed_loop=False, n_logical=N_LOGICAL,
                                    device="cpu")
    assert_leaf_equal(j_lat, t_lat, f"{axes}: latency")
    assert_state_equal(j_state, t_state, "+".join(axes))


@pytest.mark.parametrize("policy", ("baseline", "coop"))
def test_eval_cell_matches_reference(policy):
    """`driver.eval_cell` on a whole (untruncated) trace: hm_1 bursty has
    1,320 live ops in a 131,072-op padded trace, so the port scans the
    live prefix and replays the rest; the reference scans every op."""
    from repro.core.ssd.driver import eval_cell as j_eval_cell
    from repro_torch.core.ssd.driver import eval_cell as t_eval_cell
    ref = j_eval_cell(CFG_J, "hm_1", policy, "bursty")
    got = t_eval_cell(CFG_T, "hm_1", policy, "bursty", device="cpu")
    assert set(got) == set(ref)
    for key, v in ref.items():
        if key == "mean_write_latency_ms":
            assert got[key] == pytest.approx(v, rel=1e-6)
        else:
            assert got[key] == v, key
