"""The port's dry run against the reference package's: the stand-ins of
`repro_torch.launch.specs` against `repro.launch.specs` (shapes and
dtypes) for every runnable cell, the 40 cells and 8 skips, every cell's
per-device argument bytes on both production meshes against the same
arithmetic over the reference's specs, and `launch.cost_analysis`'s
FLOPs of a reduced train step and prefill against
`repro.launch.hlo_analysis.analyze_hlo` of the reference's compiled
step on one CPU device."""
from __future__ import annotations

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec

from repro.configs import ARCHS as J_ARCHS
from repro.configs import dryrun_cells as j_dryrun_cells
from repro.core.tiercache.policy import Policy as JPolicy
from repro.distributed import sharding as jsh
from repro.launch import specs as jspecs
from repro.launch.hlo_analysis import analyze_hlo
from repro.models.model_zoo import build_model as j_build_model
from repro.optim import make_optimizer as j_make_optimizer
from repro.serve.engine import make_prefill_step as j_make_prefill_step
from repro.serve.engine import make_tier_spec as j_make_tier_spec
from repro.train.train_step import TrainState as JTrainState
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.configs import ARCHS, dryrun_cells, get_shape
from repro_torch.core.tiercache.policy import Policy
from repro_torch.launch import cost_analysis, dryrun
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model_zoo import build_model
from repro_torch.optim.adamw import tree_map
from repro_torch.serve.engine import make_prefill_step, make_tier_spec
from repro_torch.train.train_step import TrainState, make_train_step

MESHES = ("single", "multi")
RUNNABLE = [(a.name, s.name) for a, s, ok, _ in dryrun_cells() if ok]


def _jax_mesh(which: str) -> Mesh:
    n, shape, axes = ((256, (16, 16), ("data", "model")) if which == "single"
                      else (512, (2, 16, 16), ("pod", "data", "model")))
    return Mesh(np.array(jax.devices() * n)[:n].reshape(shape), axes)


def _j_param_specs_like():
    """The reference's `param_specs_like`. Its module forces 512 host
    devices through XLA_FLAGS when imported; JAX has started by now, and
    the variable is put back so no later subprocess inherits it."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import param_specs_like
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return param_specs_like


def _jleaves(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(str(getattr(k, "key", getattr(k, "name", k)))
                  for k in path): leaf for path, leaf in leaves}


def _tleaves(tree) -> dict:
    out = {}
    from repro_torch.distributed.sharding import tree_map_path
    tree_map_path(lambda p, x: out.__setitem__(tuple(map(str, p)), x), tree)
    return out


def _sig(leaf):
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")
    return tuple(leaf.shape), str(leaf.dtype)


def test_cells_are_the_reference_cells():
    got = [(a.name, s.name, ok) for a, s, ok, _ in dryrun_cells()]
    want = [(a.name, s.name, ok) for a, s, ok, _ in j_dryrun_cells()]
    assert got == want
    assert len(got) == 40 and sum(not ok for *_, ok in got) == 8
    assert len(RUNNABLE) == 32


@pytest.mark.parametrize("arch,shape", RUNNABLE)
def test_input_specs_match_the_reference(arch, shape):
    """Parameters, and the batch or the decode cache, token and metrics:
    the same paths, shapes and dtypes."""
    from repro.configs import get_shape as j_get_shape
    jb = j_build_model(J_ARCHS[arch])
    tb = build_model(ARCHS[arch], device="meta")
    want = {"params": jspecs.params_specs(jb),
            **jspecs.input_specs(jb, j_get_shape(shape))}
    got = {"params": tspecs.params_specs(tb),
           **tspecs.input_specs(tb, get_shape(shape))}
    want.pop("tier_spec", None)
    got.pop("tier_spec", None)
    wl, gl = _jleaves(want), _tleaves(got)
    assert gl.keys() == wl.keys()
    bad = {k: (_sig(gl[k]), _sig(wl[k])) for k in wl
           if _sig(gl[k]) != _sig(wl[k])}
    assert not bad
    assert all(leaf.is_meta for leaf in gl.values())


def _j_argument_bytes(arch, shape_name, mesh, param_specs_like) -> int:
    """The reference's in_shardings arithmetic (`lower_cell`): each
    argument leaf's bytes over the product of its spec's axis sizes."""
    from repro.configs import get_shape as j_get_shape
    shape = j_get_shape(shape_name)
    cfg = J_ARCHS[arch]
    bundle = j_build_model(cfg)
    p = jspecs.params_specs(bundle)
    if shape.kind == "train":
        opt_init, _ = j_make_optimizer(cfg.optimizer)
        opt = jax.eval_shape(opt_init, p)
        batch = jspecs.batch_specs(cfg, shape.global_batch, shape.seq_len)
        args = [(p, jsh.param_specs(mesh, p)),
                (opt, param_specs_like(opt, p, mesh)),
                (jax.ShapeDtypeStruct((), jnp.int32), PartitionSpec()),
                (batch, jsh.train_batch_specs(mesh, batch))]
    elif shape.kind == "prefill":
        batch = jspecs.batch_specs(cfg, shape.global_batch, shape.seq_len)
        args = [(p, jsh.param_specs(mesh, p)),
                (batch, jsh.train_batch_specs(mesh, batch))]
    else:
        specs = jspecs.input_specs(bundle, shape, JPolicy.IPS_AGC)
        args = [(p, jsh.param_specs(mesh, p, mode="decode")),
                (specs["cache"], jsh.cache_specs(mesh, specs["cache"])),
                (specs["token"], jsh.fit_spec(
                    mesh, (jsh.batch_axes(mesh), None),
                    specs["token"].shape)),
                (specs["metrics"], jax.tree.map(lambda _: PartitionSpec(),
                                                specs["metrics"]))]
    total = 0
    for tree, spec_tree in args:
        leaves = jax.tree.leaves(tree)
        spec_leaves = jax.tree.leaves(
            spec_tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
        assert len(leaves) == len(spec_leaves)
        for leaf, spec in zip(leaves, spec_leaves):
            n = math.prod(leaf.shape) * jnp.dtype(leaf.dtype).itemsize
            for entry in spec:
                names = (entry if isinstance(entry, tuple)
                         else () if entry is None else (entry,))
                for a in names:
                    n //= mesh.shape[a]
            total += n
    return total


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_argument_bytes_match_the_reference_arithmetic(arch):
    """Every runnable cell of the arch on both meshes."""
    param_specs_like = _j_param_specs_like()
    shapes = [s for a, s in RUNNABLE if a == arch]
    for shape in shapes:
        infos = dryrun.plan_cell(arch, shape,
                                 {m: make_production_mesh(
                                     multi_pod=(m == "multi"))
                                  for m in MESHES}, cost=False)
        for which in MESHES:
            want = _j_argument_bytes(arch, shape, _jax_mesh(which),
                                     param_specs_like)
            assert infos[which]["memory"]["argument_bytes"] == want, (
                arch, shape, which)


def _reduced_steps():
    """(port train count, port train count without remat, port prefill
    count, reference train HLO, reference prefill HLO) of gemma-2b
    reduced, batch 2 x 64 tokens."""
    cfg_t, cfg_j = ARCHS["gemma-2b"].reduced(), J_ARCHS["gemma-2b"].reduced()
    counts = []
    for remat in (None, False):
        b = build_model(cfg_t, device="meta", remat=remat)
        p = tree_map(lambda x: x.requires_grad_(True), tspecs.params_specs(b))
        state = TrainState(p, tspecs.opt_state_specs(cfg_t, p),
                           tspecs.sds((), torch.int32))
        counts.append(cost_analysis.count(
            make_train_step(b), state, tspecs.batch_specs(cfg_t, 2, 64)))
    b = build_model(cfg_t, device="meta")
    with torch.no_grad():
        counts.append(cost_analysis.count(
            make_prefill_step(b, make_tier_spec(b, 64, Policy.IPS_AGC)),
            tspecs.params_specs(b), tspecs.batch_specs(cfg_t, 2, 64)))
    jb = j_build_model(cfg_j)
    p = jspecs.params_specs(jb)
    opt_init, _ = j_make_optimizer(cfg_j.optimizer)
    st = JTrainState(p, jax.eval_shape(opt_init, p),
                     jax.ShapeDtypeStruct((), jnp.int32))
    batch = jspecs.batch_specs(cfg_j, 2, 64)
    train = analyze_hlo(jax.jit(j_make_train_step(jb)).lower(
        st, batch).compile().as_text())
    prefill = analyze_hlo(jax.jit(j_make_prefill_step(
        jb, j_make_tier_spec(jb, 64, JPolicy.IPS_AGC))).lower(
            p, batch).compile().as_text())
    return counts, train, prefill


def test_cost_flops_match_the_reference_hlo():
    """The prefill's matrix FLOPs equal the reference's dots exactly. The
    train step's lie between the port's counts without and with remat,
    within 10% of the remat count: the reference checkpoints its layers
    with `prevent_cse=False`, so XLA shares part of the recomputed
    forward with the first one, where `torch.utils.checkpoint` recomputes
    every checkpointed layer in full."""
    (remat, no_remat, prefill), j_train, j_prefill = _reduced_steps()
    assert prefill["flops"] == j_prefill["flops"]
    assert no_remat["flops"] <= j_train["flops"] <= remat["flops"]
    assert remat["flops"] <= 1.1 * j_train["flops"]
    for c in (remat, no_remat, prefill):
        assert c["hbm_bytes"] > 0


@pytest.mark.parametrize("arch,shape", [("whisper-tiny", "decode_32k"),
                                        ("mamba2-370m", "long_500k")])
def test_cli_plans_cells_without_a_device(tmp_path, arch, shape):
    """`python -m repro_torch.launch.dryrun` on one decode cell (the tiered
    cache and the SSM state) on both meshes: ok, the step counted, the
    plan's collectives written."""
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "both",
                        "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert set(res) == {f"{arch}/{shape}/single", f"{arch}/{shape}/multi"}
    for info in res.values():
        assert info["status"] == "ok"
        assert info["cost"]["flops"] > 0
        assert info["collectives"]["total_bytes"] >= 0
    one = res[f"{arch}/{shape}/single"]
    assert one["n_devices"] == 256 and one["mesh"] == "16x16"
