"""Gradient compression for a slow all-reduce: int8 quantization with
error feedback (the port of the reference's `repro/optim/compress.py`,
the parts that run on one process).

Error feedback (the residual carried into the next step) keeps the
compression unbiased over time (Karimireddy et al., 2019). The
reference's `compressed_psum`, the reduction across processes, waits for
the port's distribution slice (`torch.distributed`).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.optim.adamw import tree_map

__all__ = ["quantize_int8", "dequantize_int8", "compress_with_feedback",
           "init_residuals"]


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


def init_residuals(grads) -> Any:
    """Zero float32 residuals shaped as the gradient tree."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)
