"""Dry run of every (architecture x input shape) cell on the production
meshes, with no device and no process group; port of the reference
package's `launch/dryrun.py`.

For each cell of `configs.dryrun_cells()` and each mesh (16x16
single-pod, 2x16x16 multi-pod: `launch.mesh`), per device:

  * the argument bytes, counted from the specs: the parameters, the
    optimizer state (each leaf with its parameter's spec where the
    shapes match, else replicated: the reference's `param_specs_like`),
    and the batch, or the decode cache, token and metrics — the
    arguments the reference's `lower_cell` passes its step;
  * the FLOPs and HBM bytes of the step (`train_step`, `prefill_step`
    or `serve_step`) counted on meta tensors by `launch.cost_analysis`,
    split evenly over the devices;
  * the collective wire bytes of the plan (`cost_analysis.
    plan_collectives`).

The reference lowers and compiles each cell for 256 or 512 forced host
devices and reads XLA's memory and cost analyses; the port plans the
same cells from the same rules without compiling anything.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out build/dryrun_torch.json
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict

import torch

from repro_torch.configs import dryrun_cells, get_arch, get_shape
from repro_torch.core.tiercache.policy import Policy
from repro_torch.distributed.sharding import (P, axes_size, batch_axes,
                                              cache_specs, fit_spec,
                                              flat_paths, local_nbytes,
                                              param_specs, train_batch_specs,
                                              tree_map_path)
from repro_torch.launch import cost_analysis, specs as lspecs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model_zoo import build_model

__all__ = ["param_specs_like", "cell_arguments", "argument_bytes",
           "plan_cell", "main"]


def param_specs_like(opt_state, params, mesh):
    """Optimizer-state specs: the parameter leaf's spec where a
    parameter's path ends the state leaf's path and the shapes match,
    otherwise replicated (adafactor's factored vectors, scalars)."""
    pspecs = flat_paths(param_specs(mesh, params))
    shapes = flat_paths(params)

    def match(path, leaf):
        for key, spec in pspecs.items():
            if path[-len(key):] == key and shapes[key].shape == leaf.shape:
                return spec
        return P()
    return tree_map_path(match, opt_state)


def cell_arguments(bundle, shape, mesh, policy=Policy.IPS_AGC) -> list:
    """[(stand-in tree, spec tree)] of the arguments the cell's step
    takes, on `mesh` (the reference's `lower_cell` in_shardings)."""
    cfg = bundle.cfg
    params = lspecs.params_specs(bundle)
    if shape.kind == "train":
        opt = lspecs.opt_state_specs(cfg, params)
        batch = lspecs.batch_specs(cfg, shape.global_batch, shape.seq_len)
        return [(params, param_specs(mesh, params)),
                (opt, param_specs_like(opt, params, mesh)),
                (lspecs.sds((), torch.int32), P()),
                (batch, train_batch_specs(mesh, batch))]
    if shape.kind == "prefill":
        batch = lspecs.batch_specs(cfg, shape.global_batch, shape.seq_len)
        return [(params, param_specs(mesh, params)),
                (batch, train_batch_specs(mesh, batch))]
    inputs = lspecs.input_specs(bundle, shape, policy)
    token = inputs["token"]
    return [(params, param_specs(mesh, params, mode="decode")),
            (inputs["cache"], cache_specs(mesh, inputs["cache"])),
            (token, fit_spec(mesh, (batch_axes(mesh), None),
                             tuple(token.shape))),
            (inputs["metrics"], {k: P() for k in inputs["metrics"]})]


def argument_bytes(mesh, arguments) -> int:
    """Per-device bytes of the arguments: each leaf's local piece."""
    total = 0
    for tree, spec_tree in arguments:
        spec_of = flat_paths(spec_tree)
        total += sum(local_nbytes(mesh, spec_of[path], tuple(leaf.shape),
                                  leaf.element_size())
                     for path, leaf in flat_paths(tree).items()
                     if isinstance(leaf, torch.Tensor))
    return total


def _step_cost(bundle, shape, policy) -> Dict:
    """Global FLOPs and HBM bytes of the cell's step on meta tensors."""
    from repro_torch.core.tiercache.manager import zero_metrics
    from repro_torch.optim.adamw import tree_map
    from repro_torch.serve.engine import (make_prefill_step, make_serve_step,
                                          make_tier_spec)
    cfg = bundle.cfg
    if shape.kind == "train":
        from repro_torch.train.train_step import TrainState, make_train_step
        params = tree_map(lambda x: x.requires_grad_(True),
                          lspecs.params_specs(bundle))
        state = TrainState(params, lspecs.opt_state_specs(cfg, params),
                           lspecs.sds((), torch.int32))
        batch = lspecs.batch_specs(cfg, shape.global_batch, shape.seq_len)
        return cost_analysis.count(make_train_step(bundle), state, batch)
    params = lspecs.params_specs(bundle)
    with torch.no_grad():
        if shape.kind == "prefill":
            tier = make_tier_spec(bundle, shape.seq_len, policy)
            batch = lspecs.batch_specs(cfg, shape.global_batch,
                                       shape.seq_len)
            return cost_analysis.count(make_prefill_step(bundle, tier),
                                       params, batch)
        tier = make_tier_spec(bundle, shape.seq_len, policy)
        with lspecs.on_meta():
            cache = bundle.make_decode_cache(shape.global_batch,
                                             shape.seq_len, tier,
                                             device=lspecs.META)
        token = lspecs.sds((shape.global_batch, 1), torch.int32)
        return cost_analysis.count(make_serve_step(bundle, tier, policy),
                                   params, cache, token, zero_metrics())


def plan_cell(arch_name: str, shape_name: str, meshes: Dict, *,
              cost: bool = True, moe_dispatch: str = "einsum",
              policy=Policy.IPS_AGC) -> Dict:
    """{mesh name: info} for one cell on each of `meshes` ({name:
    MeshSpec}); `cost` adds the step's counts (one count serves every
    mesh: the global work, split evenly)."""
    cfg = get_arch(arch_name)
    shape = get_shape(shape_name)
    bundle = build_model(cfg, moe_dispatch=moe_dispatch,
                         device=lspecs.META)
    counted = None
    if cost:
        t0 = time.perf_counter()
        counted = _step_cost(bundle, shape, policy)
        counted["count_s"] = time.perf_counter() - t0
    out = {}
    for name, mesh in meshes.items():
        args = cell_arguments(bundle, shape, mesh, policy)
        n_dev = mesh.size
        info = {"arch": arch_name, "shape": shape_name,
                "mesh": "x".join(map(str, mesh.dims)),
                "n_devices": n_dev,
                "memory": {"argument_bytes": argument_bytes(mesh, args)}}
        if counted is not None:
            batch_shards = axes_size(mesh, batch_axes(mesh))
            if shape.global_batch % batch_shards:
                batch_shards = 1            # fit_spec replicates the batch
            seq = 1 if shape.kind == "decode" else shape.seq_len
            tokens_local = shape.global_batch // batch_shards * seq
            params, pspecs = args[0]
            info["cost"] = {
                # the global work split evenly: work a spec replicates
                # (a dim that does not divide its axes) is not counted
                # again
                "flops": counted["flops"] / n_dev,
                "hbm_bytes": counted["hbm_bytes"] / n_dev,
                "global_flops": counted["flops"],
                "global_hbm_bytes": counted["hbm_bytes"],
                "count_s": round(counted["count_s"], 2)}
            info["collectives"] = cost_analysis.plan_collectives(
                mesh, params, pspecs, kind=shape.kind,
                tokens_local=tokens_local, d_model=cfg.d_model,
                remat=bool(cfg.remat))
        out[name] = info
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--moe-dispatch", default="einsum",
                    choices=("einsum", "gather"))
    ap.add_argument("--no-cost", action="store_true",
                    help="argument bytes only: skip counting the steps")
    ap.add_argument("--out", default="build/dryrun_torch.json")
    args = ap.parse_args(argv)

    meshes = {}
    if args.mesh in ("single", "both"):
        meshes["single"] = make_production_mesh(multi_pod=False)
    if args.mesh in ("multi", "both"):
        meshes["multi"] = make_production_mesh(multi_pod=True)
    if args.all:
        cells = [(a.name, s.name, ok, why) for a, s, ok, why in
                 dryrun_cells()]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape, True, "")]
    else:
        ap.error("give --all, or --arch and --shape")

    results = {}
    for arch, shape, ok, why in cells:
        if not ok:
            for m in meshes:
                results[f"{arch}/{shape}/{m}"] = {"status": "skipped",
                                                  "reason": why}
            print(f"SKIP {arch}/{shape}: {why}")
            continue
        t0 = time.perf_counter()
        try:
            infos = plan_cell(arch, shape, meshes, cost=not args.no_cost,
                              moe_dispatch=args.moe_dispatch)
        # a boundary: one cell failing is recorded, the other cells run
        except Exception as e:  # noqa: BLE001
            for m in meshes:
                results[f"{arch}/{shape}/{m}"] = {
                    "status": "error", "error": f"{type(e).__name__}: {e}"}
            print(f"  ERROR {arch}/{shape}: {type(e).__name__}: {e}")
            traceback.print_exc(limit=4)
            continue
        for m, info in infos.items():
            info["status"] = "ok"
            results[f"{arch}/{shape}/{m}"] = info
            line = (f"  {arch}/{shape}/{m}: args "
                    f"{info['memory']['argument_bytes'] / 2**30:.3f} GiB")
            if "cost" in info:
                line += (f", flops {info['cost']['flops']:.3e}, hbm "
                         f"{info['cost']['hbm_bytes']:.3e} B, coll "
                         f"{info['collectives']['total_bytes'] / 2**30:.3f}"
                         " GiB")
            print(line)
        print(f"ok {arch}/{shape} in {time.perf_counter() - t0:.1f} s",
              flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    counts = {s: sum(1 for v in results.values() if v["status"] == s)
              for s in ("ok", "skipped", "error")}
    print(f"\ndone: {counts['ok']} ok, {counts['skipped']} skipped, "
          f"{counts['error']} errors -> {args.out}")
    return 1 if counts["error"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
