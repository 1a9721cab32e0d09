"""FLOP, HBM-byte and collective accounting of a step, counted from
torch; the port's counterpart of the reference package's
`launch/hlo_analysis.py`.

The reference reads its compiled program: the optimized HLO text, its
dots scaled by loop trip counts, each top-level op's bytes, each
collective op's bytes. The port compiles no program to read, so this
module counts the step as it runs, on meta tensors (no data, no
device):

  * FLOPs: `torch.utils.flop_counter.FlopCounterMode` — 2MNK a matrix
    product, as `analyze_flops` counts each dot (a bf16 matmul's forward
    and backward count 3 x 2MNK);
  * HBM bytes: `_ByteCounter`, the charge model of `analyze_bytes` per
    op: every op's result written once and read once (2 x result bytes),
    a matrix product's operands read in full; view ops move nothing.
    Eager PyTorch fuses nothing, so this counts more traffic than the
    reference's fused HLO;
  * collective wire bytes: not from a program but from the plan
    (`plan_collectives`): each `data`-sharded parameter is all-gathered
    for its use (again in the backward) and its gradient reduce-scattered,
    a parameter replicated over data has its gradient all-reduced, the
    `pod` axis all-reduces every gradient, and each `model` row-parallel
    product ends in an all-reduce of its activation — the bytes of each
    collective's full buffer times the reference's `WIRE_FACTOR`.

The hand-written kernels cannot run on meta: inside
`_build.shapes_only()` each wrapper runs its plain version, so the
counts are the plain versions' work. Where that counts work the kernels
skip: the plain flash forward (and its plain backward) computes every
(query, key) chunk of the causal square, the kernel only the lower
half; the tiered decode's plain version dequantizes the whole int4 tier
in separate ops; the SSD intra-chunk plain version materializes its
(Q, Q) decay tensors.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels._build import shapes_only

__all__ = ["WIRE_FACTOR", "count", "plan_collectives"]

WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}

_aten = torch.ops.aten
# ops that make a view or read metadata: no HBM traffic
_VIEWS = {_aten.view, _aten._unsafe_view, _aten.t, _aten.transpose,
          _aten.permute, _aten.expand, _aten.as_strided, _aten.slice,
          _aten.select, _aten.unsqueeze, _aten.squeeze, _aten.alias,
          _aten.detach, _aten.split, _aten.split_with_sizes, _aten.unbind,
          _aten.chunk, _aten.narrow, _aten.view_as_real,
          _aten.view_as_complex, _aten.diagonal, _aten.unfold,
          _aten.lift_fresh, _aten.sym_size, _aten.sym_stride,
          _aten.sym_numel, _aten.empty, _aten.empty_strided,
          _aten._reshape_alias}
# matrix products: their operands are read in full
_PRODUCTS = {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm,
             _aten.convolution, _aten._scaled_dot_product_flash_attention,
             _aten._scaled_dot_product_efficient_attention}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _ByteCounter(TorchDispatchMode):
    """HBM bytes by `analyze_bytes`'s charge model, op by op."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        if packet in _VIEWS:
            return out
        n = 2 * sum(_nbytes(t) for t in _tensors(out))
        if packet in _PRODUCTS:
            n += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        self.bytes += n
        return out


def count(fn, *args, **kwargs) -> Dict:
    """{"flops", "hbm_bytes", "result"} of fn(*args, **kwargs), run on
    whatever tensors it is given (meta tensors: shapes alone), the
    kernels' wrappers on their plain versions."""
    bytes_mode = _ByteCounter()
    flops_mode = FlopCounterMode(display=False)
    with shapes_only(), flops_mode, bytes_mode:
        result = fn(*args, **kwargs)
    return {"flops": float(flops_mode.get_total_flops()),
            "hbm_bytes": float(bytes_mode.bytes), "result": result}


# output projections whose contracted dims the plan may put on `model`
# (the dims counted from the end; MoE weights add the expert dim -3,
# whose combine sums over experts)
_CONTRACTED = {"wq": (-3,), "wk": (-3,), "wv": (-3,), "wo": (-3, -2),
               "w_gate": (-2,), "w_up": (-2,), "w_down": (-2,),
               "out_proj": (-2,), "in_proj": (-2,)}


def _has(entry, axis) -> bool:
    return entry == axis or (isinstance(entry, tuple) and axis in entry)


def plan_collectives(mesh, params, specs, *, kind: str, tokens_local: int,
                     d_model: int, remat: bool = True) -> Dict[str, float]:
    """Per-device collective wire bytes of one step under the plan.

    `params`: the parameter stand-ins (global shapes); `specs` their
    specs on `mesh`; `kind` train, prefill or decode; `tokens_local` the
    tokens one device's activations hold (local batch x sequence);
    activations bf16. Training and prefill gather each `data`-sharded
    weight for its use (training again in the backward, and it
    reduce-scatters the gradient; a gradient replicated over data is
    all-reduced, and so is every gradient over `pod`); decode gathers
    no weight (its plan contracts locally). A product whose contracted
    dim is sharded — on `model`, or in decode on `data` too (the 2D
    expert layout) — all-reduces its activation once a pass (training:
    forward, remat's recompute, backward). Returns bytes by collective
    and `total_bytes`."""
    from repro_torch.distributed.sharding import flat_paths, local_nbytes
    out = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0}
    sizes = mesh.shape
    data, pod = sizes.get("data", 1), sizes.get("pod", 1)
    spec_of = flat_paths(specs)
    act = tokens_local * d_model * 2
    passes = (3 if remat else 2) if kind == "train" else 1
    reducing = ("model", "data") if kind == "decode" else ("model",)
    for path, leaf in flat_paths(params).items():
        spec, shape = spec_of[path], tuple(leaf.shape)
        local = local_nbytes(mesh, spec, shape, leaf.element_size())
        on_data = any(_has(e, "data") for e in spec)
        if kind != "decode" and on_data and data > 1:
            out["all-gather"] += (2 if kind == "train" else 1) * (
                local * data * WIRE_FACTOR["all-gather"])
        if kind == "train":
            if on_data and data > 1:
                out["reduce-scatter"] += (local * data
                                          * WIRE_FACTOR["reduce-scatter"])
            elif data > 1:
                out["all-reduce"] += local * WIRE_FACTOR["all-reduce"]
            if pod > 1:
                out["all-reduce"] += local * WIRE_FACTOR["all-reduce"]
        name = path[-1]
        in_moe = len(path) > 1 and path[-2] == "moe"    # expert weights
        if name not in _CONTRACTED or len(shape) < 2:
            continue
        dims = _CONTRACTED[name] + ((-3,) if in_moe else ())
        if any(len(spec) >= -d and any(_has(spec[d], a) and sizes[a] > 1
                                       for a in reducing) for d in dims):
            stacked = len(shape) > (3 if in_moe else 2) + (
                name in ("wq", "wk", "wv", "wo"))
            n_layers = shape[0] if stacked else 1
            out["all-reduce"] += (passes * n_layers * act
                                  * WIRE_FACTOR["all-reduce"])
    out["total_bytes"] = sum(out.values())
    return out
