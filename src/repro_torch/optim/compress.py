"""Gradient compression for a slow all-reduce: int8 quantization with
error feedback (the port of the reference's `repro/optim/compress.py`,
and `compressed_psum` over a `torch.distributed` process group).

Error feedback (the residual carried into the next step) keeps the
compression unbiased over time (Karimireddy et al., 2019).
`compressed_psum` is the reference's all-reduce of the int8 payload
across a slow axis: there a `shard_map` axis, here a process group.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import tree_map

__all__ = ["quantize_int8", "dequantize_int8", "compress_with_feedback",
           "reduce_parts", "compressed_psum", "init_residuals"]


def quantize_int8(x):
    """-> (int8 payload, float32 per-tensor scale max|x| / 127)."""
    scale = x.abs().max() / 127.0
    safe = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(x / safe), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compress_with_feedback(grad, residual):
    """-> (int8 payload, scale, new residual). grad + residual is
    quantized; the quantization error becomes the next step's
    residual."""
    target = grad.to(torch.float32) + residual
    q, scale = quantize_int8(target)
    err = target - dequantize_int8(q, scale)
    return q, scale, err


def reduce_parts(q, scale, group=None):
    """The three reductions of `compressed_psum` over `group`: (the int32
    sum of the int8 payloads, the mean scale, the float32 sum of the
    corrections q * scale - q * mean scale). Outside a process group,
    the one-rank case.

    The mean scale is exact and the same on every rank: each rank puts
    its scale in its own slot of an n-vector of zeros, the vectors are
    summed (adding zeros rounds nothing) and the n scales are added in
    rank order, as a one-process sum over the stacked ranks adds them.
    The payload's integer sum is exact in any order; the correction's
    float32 sum is in the backend's order."""
    in_group = dist.is_initialized()
    n = dist.get_world_size(group) if in_group else 1
    part = q.to(torch.int32)
    summed = part.clone()
    slots = torch.zeros(n, dtype=torch.float32, device=scale.device)
    slots[dist.get_rank(group) if in_group else 0] = scale
    if in_group:
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(slots, op=dist.ReduceOp.SUM, group=group)
    total_scale = slots[0]
    for i in range(1, n):
        total_scale = total_scale + slots[i]
    mean_scale = total_scale / n
    correction = dequantize_int8(q, scale) - part.to(torch.float32) * (
        mean_scale)
    if in_group:
        dist.all_reduce(correction, op=dist.ReduceOp.SUM, group=group)
    return summed, mean_scale, correction


def compressed_psum(grad, residual, group=None):
    """Error-feedback int8 all-reduce over `group` (default: the whole
    process group; every rank calls it). Returns (the mean-reduced
    float32 gradient, the new residual).

    As the reference: the int8 payload is summed in int32 (1 byte an
    element on the wire instead of 4, no overflow); each rank's scale
    differs, so the float32 correction is summed beside it, and the
    total is payload sum x mean scale + correction, over n, the group's
    size (1 outside a group): `reduce_parts`."""
    q, scale, err = compress_with_feedback(grad, residual)
    summed, mean_scale, correction = reduce_parts(q, scale, group)
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    total = summed.to(torch.float32) * mean_scale + correction
    return total / float(n), err


def init_residuals(grads) -> Any:
    """Zero float32 residuals shaped as the gradient tree."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)
