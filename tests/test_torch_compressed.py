"""Port vs reference: the compressed-segment path and carried-over state.

* `sim.run_compressed` (K = 32 lanes with the `src`/`scat_lba` hazard
  plan, then the pad tail) equals the live JAX `run_compressed`, packed
  and unpacked, leaf for leaf and latency for latency.
* `kernels/ssd_step/ref.py::run_segments_ref` — the plain version of the
  CUDA kernel — equals the reference's `run_segments_ref` (the oracle of
  the reference's Pallas kernel) from a mid-trace state.
* `interop.state_from_jax`: a state the reference reached half way
  through a trace, carried across, finishes identically on both sides.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.ssd import sim as jsim
from repro.kernels.ssd_step.ref import run_segments_ref as j_segments_ref
from repro.workloads.compress import compress_ops as j_compress
from repro_torch import interop
from repro_torch.core.ssd import sim as tsim
from repro_torch.core.ssd.policies.state import init_state, map_state
from repro_torch.kernels.ssd_step import ops as ssd_step
from repro_torch.kernels.ssd_step.ref import run_segments_ref
from repro_torch.workloads.compress import compress_ops as t_compress
from torch_port_util import (CFG_J, CFG_T, MODES, N_LOGICAL, PAPER_POLICIES,
                             assert_leaf_equal, assert_state_equal,
                             fixture_ops)

QUANTUM = 1024      # trim quantum of the test plans: 2048 live ops scan
#                     as 64 segments, the 8192 tail pads are replayed


@pytest.fixture(scope="module")
def plans():
    out = {}
    for name in ("hm_0", "proj_0"):
        ops = fixture_ops(name)
        out[name] = (j_compress(ops, quantum=QUANTUM),
                     t_compress(ops, quantum=QUANTUM))
    return out


def test_compress_plans_are_identical(plans):
    for name, (j_comp, t_comp) in plans.items():
        for key, v in j_comp.segs.items():
            got = t_comp.segs[key]
            assert got.dtype == v.dtype and np.array_equal(got, v), \
                f"{name}: segs[{key}]"
        assert (t_comp.t_len, t_comp.t_trim, t_comp.n_pad, t_comp.pad_t) \
            == (j_comp.t_len, j_comp.t_trim, j_comp.n_pad, j_comp.pad_t)
        assert t_comp.n_pad > 0 and t_comp.segs["lba"].shape[1] == 32


CASES = ([(p, m, "hm_0", True) for p in PAPER_POLICIES for m in MODES]
         + [("coop", "daily", "proj_0", False),
            ("baseline", "bursty", "proj_0", False)])


@pytest.mark.parametrize("policy,mode,trace,packed", CASES)
def test_run_compressed_matches_reference(plans, policy, mode, trace,
                                          packed):
    j_comp, t_comp = plans[trace]
    closed = mode == "bursty"
    j_lat, j_state = jsim.run_compressed(CFG_J, policy, j_comp,
                                         closed_loop=closed,
                                         n_logical=N_LOGICAL, packed=packed)
    t_lat, t_state = tsim.run_compressed(CFG_T, policy, t_comp,
                                         closed_loop=closed,
                                         n_logical=N_LOGICAL, packed=packed,
                                         device="cpu")
    label = f"{trace}/{mode}/{policy}/packed={packed}"
    assert_leaf_equal(j_lat, t_lat, f"{label}: latency")
    assert_state_equal(j_state, t_state, label)


def _jax_half_state(ops, policy, closed, n_half):
    """The reference's state after the first `n_half` ops of `ops`."""
    head = {k: v[:n_half] for k, v in ops.items() if isinstance(v, np.ndarray)}
    _, state = jsim.run_trace(CFG_J, policy, head, closed_loop=closed,
                              n_logical=N_LOGICAL)
    return state


def test_segment_plain_version_matches_reference_oracle(plans):
    """Port `run_segments_ref` vs the reference's kernel oracle, both
    started from a state the reference reached after 1024 ops."""
    j_comp, _ = plans["proj_0"]
    ops = fixture_ops("proj_0")
    policy, closed = "ips_agc", False
    j_half = _jax_half_state(ops, policy, closed, 1024)
    segs = {k: v[32:] for k, v in j_comp.segs.items()}   # ops 1024..2047
    j_params = jsim.default_params(CFG_J, policy, 0.07)
    j_lat, (j_red, j_loc, j_lep) = j_segments_ref(
        CFG_J, policy, {k: jax.numpy.asarray(v) for k, v in segs.items()},
        j_half, closed_loop=closed, params=j_params)
    t_state0 = interop.state_from_jax(
        [np.asarray(x) for x in jax.tree.leaves(j_half)], device="cpu")
    t_params = interop.params_from_jax(
        [np.asarray(x) for x in jax.tree.leaves(j_params)], device="cpu")
    t_lat, (t_red, t_loc, t_lep) = run_segments_ref(
        CFG_T, policy, {k: torch.as_tensor(v) for k, v in segs.items()},
        t_state0, closed_loop=closed, params=t_params)
    assert_leaf_equal(j_lat, t_lat, "latency")
    assert_state_equal(j_red, t_red, "reduced carry")
    assert_leaf_equal(j_loc, t_loc, "loc")
    assert_leaf_equal(j_lep, t_lep, "loc_ep")


@pytest.mark.parametrize("policy,mode", [("baseline", "daily"),
                                         ("coop", "bursty")])
def test_state_from_jax_finishes_identically(policy, mode):
    """Run the reference over the first half of a trace, carry its state
    across, finish on both sides: the final states are equal, and equal
    to the port's run over the whole trace."""
    closed = mode == "bursty"
    ops = fixture_ops("hm_0", max_ops=1024, n_pad=0)
    j_half = _jax_half_state(ops, policy, closed, 512)
    tail = {k: v[512:] for k, v in ops.items() if isinstance(v, np.ndarray)}
    j_step = jsim.make_step(CFG_J, policy, closed_loop=closed)
    j_final, j_lat = jax.lax.scan(j_step, j_half, jsim.as_ops(tail))

    t_half = interop.state_from_jax(
        [np.asarray(x) for x in jax.tree.leaves(j_half)], device="cpu")
    assert_state_equal(j_half, t_half, "carried state")
    t_params = tsim.default_params(CFG_T, policy, device="cpu")
    seg = {k: v.reshape(1, -1, 1) for k, v in
           tsim.as_ops(tail, device="cpu").items()}
    t_lat, t_final = ssd_step.run_stream(
        CFG_T, policy, seg, map_state(lambda x: x[None], t_half),
        closed_loop=closed, params=map_state(lambda x: x[None], t_params))
    assert_leaf_equal(j_lat, t_lat.reshape(-1), "latency")
    assert_state_equal(j_final, map_state(lambda x: x[0], t_final), "final")
    _, t_whole = tsim.run_trace(CFG_T, policy, ops, closed_loop=closed,
                                n_logical=N_LOGICAL, device="cpu")
    assert_state_equal(j_final, t_whole, "whole-trace port run")


def test_interop_refuses_what_the_port_does_not_carry():
    state = init_state(CFG_T, 64, device="cpu")
    leaves = [x.numpy() for x in state if x is not None]
    with pytest.raises(ValueError, match="telemetry"):
        interop.state_from_jax(leaves + [np.zeros(3, np.float32)],
                               device="cpu")
    bad = list(leaves)
    bad[6] = bad[6].astype(np.int32)                    # loc must be int8
    with pytest.raises(TypeError, match="loc"):
        interop.state_from_jax(bad, device="cpu")
    mixed = list(leaves)
    mixed[1] = mixed[1].astype(np.int16)                # one field packed
    with pytest.raises(TypeError, match="mix packed"):
        interop.state_from_jax(mixed, device="cpu")
    p = interop.params_from_jax([np.int32(8), np.int32(0),
                                 np.float32(1.0), np.float32(0.0)],
                                device="cpu")
    assert int(p.cap_boost) == 0
    with pytest.raises(ValueError, match="endurance"):
        interop.params_from_jax([np.int32(8)] * 7, device="cpu")
