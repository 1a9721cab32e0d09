"""Rank functions of `tests/test_torch_distributed.py`, spawned by
`repro_torch.distributed.group.spawn` (module-level and free of JAX, so
that a spawned rank imports only torch and the port)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import MeshSpec, device_mesh
from repro_torch.optim import compress
from repro_torch.optim.compress import compressed_psum

PSUM_STEPS = 50
SCEN_OPS = 128
# one reduced model a family whose forward calls `constrain_bsd`
# (transformer.py, hybrid.py's two stacks, encdec.py)
CONSTRAINED_ARCHS = ("gemma-2b", "mamba2-370m", "zamba2-1.2b",
                     "whisper-tiny")


def state_tree(seed: int = 0) -> dict:
    """A small train-state-like tree: bf16 and float32 leaves with the
    reference's parameter names, and an int32 step."""
    g = torch.Generator().manual_seed(seed)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype)
    params = {"embed": randn(16, 8, dtype=torch.bfloat16),
              "layers": {"attn": {"wq": randn(2, 8, 4, 2),
                                  "wo": randn(2, 4, 2, 8)},
                         "mlp": {"w_down": randn(2, 12, 8)},
                         "ln1": randn(2, 8)},
              "final_norm": randn(8)}
    return {"params": params, "mu": {k: v for k, v in params.items()},
            "step": torch.tensor(7, dtype=torch.int32)}


def state_specs(mesh, tree) -> dict:
    return {"params": sharding.param_specs(mesh, tree["params"]),
            "mu": sharding.param_specs(mesh, tree["mu"]),
            "step": sharding.P()}


def four_ranks(rank: int, world: int, grads: np.ndarray, ckpt_dir: str):
    """compressed_psum on this rank's gradient (one call, then PSUM_STEPS
    of error feedback), and the 1-rank checkpoint at `ckpt_dir`
    restored onto a (data 2, model 2) mesh: this rank's pieces."""
    g = torch.from_numpy(grads[rank])
    out, res = compressed_psum(g, torch.zeros_like(g))
    acc, residual = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(PSUM_STEPS):
        step_out, residual = compressed_psum(g, residual)
        acc += step_out
    mesh = MeshSpec(("data", "model"), (2, 2))
    dm = device_mesh(mesh, "cpu")
    target = state_tree(seed=1)         # other values: restore overwrites
    got, step = ckpt.restore(ckpt_dir, target, mesh=dm,
                             specs=state_specs(mesh, target))
    pieces = {k: (v.to_local().view(torch.int16).numpy()
                  if v.dtype == torch.bfloat16 else v.to_local().numpy())
              for k, v in ckpt.flatten(got).items()}
    placements = {k: str(v.placements) for k, v in ckpt.flatten(got).items()}
    return {"out": out.numpy(), "res": res.numpy(),
            "acc": (acc / PSUM_STEPS).numpy(), "step": step,
            "coords": dict(zip(mesh.axis_names, dm.get_coordinate())),
            "pieces": pieces, "placements": placements}


def _hidden(arch: str):
    """(forward, its inputs) of `arch` reduced: the final hidden states
    of its stack (whisper's decoder over its encoder's output)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import encdec, hybrid
    from repro_torch.models import transformer as tx
    cfg = ARCHS[arch].reduced()
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, 64, (2, 16), generator=gen)
    if cfg.family == "audio":
        frames = torch.randn(2, 16, cfg.d_model, generator=gen).to(
            torch.bfloat16)
        return (lambda p, tok, fr: encdec.decoder_hidden(
            p, cfg, tok, encdec.encode(p, cfg, fr))[0]), (tokens, frames)
    fn = {"ssm": hybrid.ssm_lm_hidden, "hybrid": hybrid.hybrid_lm_hidden
          }.get(cfg.family, tx.lm_hidden)
    return (lambda p, tok: fn(p, cfg, tok)[0]), (tokens,)


def constrained_forward(arch: str, dm) -> dict:
    """`arch` reduced run twice on this rank: on plain tensors with no
    mesh, and with its parameters and inputs replicated DTensors on
    `dm` under `activation_mesh(dm)`. Returns the DTensor run's output
    placements, every constraint's result placements, and both outputs
    (the sharded one gathered whole)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import ARCHS
    from repro_torch.distributed import constraints
    from repro_torch.models.model_zoo import build_model
    params = build_model(ARCHS[arch].reduced(), device="cpu").init(
        torch.Generator().manual_seed(1))
    fn, inputs = _hidden(arch)
    want = fn(params, *inputs)

    def replicated(tree):
        return sharding.tree_map_path(lambda _, x: DTensor.from_local(
            x, dm, [Replicate()] * dm.ndim, run_check=False), tree)
    seen, real = [], constraints.constrain

    def recorded(x, *dims):
        y = real(x, *dims)
        seen.append(str(y.placements))
        return y
    constraints.constrain = recorded
    try:
        with constraints.activation_mesh(dm), implicit_replication():
            got = fn(replicated(params), *replicated(inputs))
    finally:
        constraints.constrain = real
    return {"placements": str(got.placements), "constrained": seen,
            "got": got.full_tensor().float().numpy(),
            "want": want.float().numpy()}


def swapped_gather(fn):
    """Run `fn()` with `group.all_gather_objects` handing back ranks 0
    and 1's parts swapped (a planted fault of the gathers that order
    results by rank)."""
    from repro_torch.distributed import group
    real = group.all_gather_objects

    def swapped(obj, group=None):
        parts = real(obj, group)
        parts[0], parts[1] = parts[1], parts[0]
        return parts
    group.all_gather_objects = swapped
    try:
        return fn()
    finally:
        group.all_gather_objects = real


def two_ranks(rank: int, world: int, ckpt_dir: str, max_ops: int):
    """The state tree saved sharded under (data 2, model 1) by 2 ranks;
    the quick grid and a three-member scenario evaluation over the 2
    ranks, the latter also with a gather that swaps the ranks' parts;
    shard_cells on a cell count that does not divide; each family's
    reduced forward under the mesh's activation constraints."""
    from repro_torch.configs.ssd_paper import PAPER_SSD
    from repro_torch.core.ssd import fleet
    from repro_torch.search.scenario import evaluate_stats
    from repro_torch.sweep.grid import named_grid
    from repro_torch.sweep.runner import run_sweep
    from repro_torch.workloads import TRACES, TraceCache
    mesh = MeshSpec(("data", "model"), (2, 1))
    dm = device_mesh(mesh, "cpu")
    tree = state_tree()
    ckpt.save(ckpt_dir, sharding.shard_tree(tree, dm,
                                            state_specs(mesh, tree)),
              step=11)
    cfg = PAPER_SSD.scaled(128)
    res = run_sweep(cfg, named_grid("quick"), max_ops=max_ops, device="cpu",
                    trace_cache=TraceCache(use_disk=False))
    members = [TRACES["hm_0"], TRACES["proj_0"], TRACES["stg_0"]]

    def scenario():
        return evaluate_stats(cfg, members, ("ips", "baseline"),
                              max_ops=SCEN_OPS, device="cpu")
    scen = scenario()
    scen_swapped = swapped_gather(scenario)
    skips = fleet.shard_skip_count()
    kept = fleet.shard_cells({"a": np.arange(3)})["a"]
    return {"sweep": {pt.key: v for pt, v in res.items()},
            "order": [pt.key for pt in res], "scenario": scen,
            "scenario_swapped": scen_swapped,
            "skips": fleet.shard_skip_count() - skips, "kept": kept,
            "quantum": fleet.cell_quantum(),
            "constrained": {arch: constrained_forward(arch, dm)
                            for arch in CONSTRAINED_ARCHS}}


def card_ranks(rank: int, world: int, ckpt_dir: str, max_ops: int):
    """On the card, ranks sharing it over gloo: compressed_psum against
    the one-process computation over the stacked ranks, a state sharded
    under (data 2, model 1) saved and restored onto the same plan, the
    quick grid's slice in one ssd_step launch."""
    from repro_torch.configs.ssd_paper import PAPER_SSD
    from repro_torch.kernels.ssd_step import ops as ssd_step
    from repro_torch.sweep.grid import named_grid
    from repro_torch.sweep.runner import run_sweep
    from repro_torch.workloads import TraceCache
    dev = torch.device("cuda", torch.cuda.current_device())
    grads = [torch.randn(4096, generator=torch.Generator(dev).manual_seed(
        r), device=dev) for r in range(world)]
    out, err = compressed_psum(grads[rank], torch.zeros_like(grads[rank]))
    parts = [compress.compress_with_feedback(g, torch.zeros_like(g))
             for g in grads]
    mean = parts[0][1]
    for p in parts[1:]:
        mean = mean + p[1]
    mean = mean / world
    payload = torch.stack([p[0].to(torch.int32) for p in parts]).sum(0)
    corr = sum(compress.dequantize_int8(q, s) - q.to(torch.float32) * mean
               for q, s, _ in parts)
    want = (payload.to(torch.float32) * mean + corr) / world
    psum_err = float((out - want).abs().max() / want.abs().max())
    mesh = MeshSpec(("data", "model"), (2, 1))
    dm = device_mesh(mesh, "cuda")
    tree = {k: v for k, v in state_tree().items()}
    specs = state_specs(mesh, tree)
    ckpt.save(ckpt_dir, sharding.shard_tree(tree, dm, specs, device=dev),
              step=2)
    got, _ = ckpt.restore(ckpt_dir, tree, mesh=dm, specs=specs)
    coords = mesh.coords(rank)
    flat_specs = ckpt.flatten(specs)
    pieces_equal = all(
        torch.equal(v.to_local().cpu(), tree_leaf[sharding.local_slices(
            mesh, flat_specs[k], tree_leaf.shape, coords)])
        and v.to_local().device == dev
        for (k, v), tree_leaf in zip(ckpt.flatten(got).items(),
                                     ckpt.flatten(tree).values()))
    ssd_step.reset()
    res = run_sweep(PAPER_SSD.scaled(128), named_grid("quick"),
                    max_ops=max_ops, device="cuda",
                    trace_cache=TraceCache(use_disk=False))
    return {"psum_err": psum_err, "residual_equal": bool(torch.equal(
        err, parts[rank][2])), "pieces_equal": pieces_equal,
            "launches": ssd_step.launches,
            "sweep": {pt.key: v for pt, v in res.items()}}


def card_nccl(rank: int, world: int):
    """compressed_psum on a 1-rank NCCL group: the one-process answer."""
    import torch.distributed as dist
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.randn(4096, generator=torch.Generator(dev).manual_seed(0),
                    device=dev)
    out, err = compressed_psum(g, torch.zeros_like(g))
    q, s, want_err = compress.compress_with_feedback(g, torch.zeros_like(g))
    qf = q.to(torch.float32)
    want = qf * s + (qf * s - qf * s)      # n = 1: a correction of zeros
    return {"backend": dist.get_backend(), "out_equal": bool(torch.equal(
        out, want)), "err_equal": bool(torch.equal(err, want_err))}
