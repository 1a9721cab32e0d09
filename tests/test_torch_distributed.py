"""The port's distribution on the CPU, over gloo ranks spawned by
`repro_torch.distributed.group.spawn`, against the reference package:
`compressed_psum` over 4 ranks against the reference's run under
`jax.vmap(..., axis_name="pod")` over the stacked ranks; checkpoints
written by 2 ranks and read by the reference's `ckpt.restore`, and a
1-rank checkpoint restored elastically onto a 2x2 mesh of 4 ranks; the
quick grid and the scenario evaluation over 2 ranks against one
process (the pads dropped), and a gather that swaps two ranks' parts
caught; each family's reduced forward under the activation constraints
on a 2-rank mesh against its run without one."""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.optim.compress import compressed_psum as j_compressed_psum
from repro_torch.checkpoint import ckpt, msgpack
from repro_torch.configs.ssd_paper import PAPER_SSD
from repro_torch.distributed import group, sharding
from repro_torch.launch.mesh import MeshSpec
from repro_torch.search.scenario import evaluate_stats
from repro_torch.sweep.grid import named_grid
from repro_torch.sweep.runner import run_sweep
from repro_torch.workloads import TRACES, TraceCache

import torch_dist_util as du

SWEEP_OPS = 256


@pytest.fixture(scope="module")
def grads():
    return np.random.default_rng(0).standard_normal((4, 64)).astype(
        np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, grads):
    """One 4-rank and one 2-rank spawn; every test reads their results."""
    one_rank = str(tmp_path_factory.mktemp("ckpt_one_rank"))
    ckpt.save(one_rank, du.state_tree(), step=3)
    two_rank = str(tmp_path_factory.mktemp("ckpt_two_ranks"))
    four = group.spawn(du.four_ranks, 4, grads, one_rank)
    two = group.spawn(du.two_ranks, 2, two_rank, SWEEP_OPS)
    return {"four": four, "two": two, "two_rank_dir": two_rank}


def _reference_psum(grads):
    out, res = jax.vmap(lambda g, r: j_compressed_psum(g, r, "pod"),
                        axis_name="pod")(jnp.asarray(grads),
                                         jnp.zeros_like(grads))
    return np.asarray(out), np.asarray(res)


def test_compressed_psum_matches_the_reference(runs, grads):
    """Each rank's mean-reduced gradient within 1e-6 of the largest
    |output| of the reference's (the correction's float32 sum runs in
    gloo's order, the reference's in XLA's), its residual equal."""
    want_out, want_res = _reference_psum(grads)
    for r, got in enumerate(runs["four"]):
        err = np.max(np.abs(got["out"] - want_out[r]))
        assert err <= 1e-6 * np.max(np.abs(want_out[r])), (r, err)
        np.testing.assert_array_equal(got["res"], want_res[r])
    # every rank ends with the same reduced gradient
    for got in runs["four"][1:]:
        np.testing.assert_array_equal(got["out"], runs["four"][0]["out"])


def test_compressed_psum_error_feedback_converges(runs, grads):
    """50 steps with the residual carried: the mean output within the
    reference test's 0.02 of the ranks' mean gradient."""
    want = grads.mean(axis=0)
    for got in runs["four"]:
        assert np.max(np.abs(got["acc"] - want)) < 0.02


def test_compressed_psum_outside_a_group_is_the_identity_reduction(grads):
    """One process: n = 1, so the output is the dequantized payload, as
    the reference's one-member axis gives it."""
    g = torch.from_numpy(grads[0])
    out, res = du.compressed_psum(g, torch.zeros_like(g))
    want_out, want_res = jax.vmap(
        lambda g, r: j_compressed_psum(g, r, "pod"), axis_name="pod")(
            jnp.asarray(grads[:1]), jnp.zeros_like(grads[:1]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_out[0]))
    np.testing.assert_array_equal(res.numpy(), np.asarray(want_res[0]))


def _shard_keys(path):
    keys = {}
    for name in sorted(os.listdir(path)):
        if name.endswith(".msgpack.zst"):
            import zlib
            with open(os.path.join(path, name), "rb") as f:
                keys[name] = set(msgpack.unpackb(zlib.decompress(f.read())))
    return keys


def test_two_rank_checkpoint_reads_in_the_reference(runs):
    """2 ranks under (data 2, model 1): one shard file a rank, no key in
    two files, every leaf written whole; the reference's restore reads
    it, every leaf equal to the bit."""
    path = runs["two_rank_dir"]
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["num_shards"] == 2 and manifest["step"] == 11
    keys = _shard_keys(path)
    assert len(keys) == 2 and all(keys.values())
    a, b = keys.values()
    assert not a & b and a | b == set(manifest["keys"])
    want = {k: (v.view(torch.int16).numpy() if v.dtype == torch.bfloat16
                else v.numpy()) for k, v in ckpt.flatten(
                    du.state_tree()).items()}
    target = jax.tree.map(lambda x: jnp.zeros(x.shape),
                          {k: v for k, v in du.state_tree().items()
                           if k != "step"})
    target["step"] = jnp.zeros((), jnp.int32)
    got, step = jckpt.restore(path, target)
    assert step == 11
    flat, _ = jckpt._flatten(got)
    assert set(flat) == set(want)
    for k, v in flat.items():
        v = np.asarray(v)
        if v.dtype.name == "bfloat16":
            v = v.view(np.int16)
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_one_rank_checkpoint_restores_onto_a_2x2_mesh(runs):
    """Each of 4 ranks holds its DTensor piece of every leaf, equal to
    the bit to the global array's slice at its coordinate."""
    mesh = MeshSpec(("data", "model"), (2, 2))
    tree = du.state_tree()
    specs = ckpt.flatten(du.state_specs(mesh, tree))
    seen = set()
    for got in runs["four"]:
        assert got["step"] == 3
        seen.add(tuple(got["coords"].values()))
        for key, leaf in ckpt.flatten(tree).items():
            want = leaf[sharding.local_slices(mesh, specs[key], leaf.shape,
                                              got["coords"])]
            want = (want.view(torch.int16) if want.dtype == torch.bfloat16
                    else want).numpy()
            np.testing.assert_array_equal(got["pieces"][key], want,
                                          err_msg=key)
        assert "Shard(dim=1)" in got["placements"]["params/embed"]
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_sweep_over_two_ranks_equals_one_process(runs):
    """The quick grid over 2 ranks: every point's metrics equal to one
    process's, in the points' order, the pads dropped."""
    cfg = PAPER_SSD.scaled(128)
    points = named_grid("quick")
    want = run_sweep(cfg, points, max_ops=SWEEP_OPS, device="cpu",
                     trace_cache=TraceCache(use_disk=False))
    for got in runs["two"]:
        assert got["order"] == [pt.key for pt in points]
        assert got["sweep"] == {pt.key: v for pt, v in want.items()}


@pytest.fixture(scope="module")
def scenario_one_process():
    return evaluate_stats(PAPER_SSD.scaled(128),
                          [TRACES["hm_0"], TRACES["proj_0"],
                           TRACES["stg_0"]], ("ips", "baseline"),
                          max_ops=du.SCEN_OPS, device="cpu")


def test_scenario_over_two_ranks_equals_one_process(runs,
                                                    scenario_one_process):
    """Three synthesized members padded to 4, the group's multiple (the
    last member replayed), and sharded: the scores equal one process's,
    three of them."""
    want = scenario_one_process
    for got in runs["two"]:
        for policy in want:
            for k in ("lat", "waf"):
                np.testing.assert_array_equal(got["scenario"][policy][k],
                                              want[policy][k])


def test_scenario_gather_that_swaps_two_ranks_is_caught(
        runs, scenario_one_process):
    """The same evaluation with a gather that hands back the two ranks'
    parts swapped: its members come back out of order (the pad among
    them), and the comparison above fails it."""
    want = scenario_one_process
    for got in runs["two"]:
        with pytest.raises(AssertionError):
            for policy in want:
                for k in ("lat", "waf"):
                    np.testing.assert_array_equal(
                        got["scenario_swapped"][policy][k], want[policy][k])


def test_shard_cells_skip_and_quantum(runs):
    """Over 2 ranks: a 3-cell axis stays whole on each rank and counts
    one skip; the quantum is the group's size."""
    for got in runs["two"]:
        assert got["skips"] == 1
        np.testing.assert_array_equal(got["kept"], np.arange(3))
        assert got["quantum"] == 2


@pytest.mark.parametrize("arch", du.CONSTRAINED_ARCHS)
def test_constraints_shard_the_forward_on_a_two_rank_mesh(runs, arch):
    """Each family reduced, its parameters and inputs replicated
    DTensors on a (data 2, model 1) mesh of 2 gloo ranks under
    `activation_mesh`: every `constrain_bsd` leaves the residual stream
    batch-sharded over `data` (nothing else in the forward shards it),
    and the gathered output equals the run without a mesh to the bit
    (each rank computes its batch rows as the whole batch's)."""
    for got in runs["two"]:
        run = got["constrained"][arch]
        want_placements = "(Shard(dim=0), Replicate())"
        assert run["constrained"]
        assert set(run["constrained"]) == {want_placements}
        assert run["placements"] == want_placements
        np.testing.assert_array_equal(run["got"], run["want"])


def test_cli_devices_prints_the_one_process_table(capfd):
    """`python -m repro_torch.sweep.cli --grid quick --devices 2` prints
    the same result table and geomeans as one process."""
    from repro_torch.sweep import cli

    def table(argv):
        assert cli.main(argv) == 0
        out = capfd.readouterr().out
        return out[out.index("cell "):]
    argv = ["--grid", "quick", "--device", "cpu", "--max-ops", "128",
            "--no-save", "--no-trace-cache-disk"]
    assert table(argv + ["--devices", "2"]) == table(argv)
