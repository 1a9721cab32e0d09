"""Density encodings for the tiered KV cache (the port of the reference's
`repro/core/tiercache/quant.py`).

The paper's SLC (1 bit/cell, fast) vs TLC (3 bits/cell, dense) maps to
bf16 pages (fast append/read) vs packed-int4 pages (4x tokens per byte,
dequant on read). Symmetric groupwise int4: two nibbles per uint8 along
the trailing feature axis, one float32 scale per group.

`quantize_int4` of a CUDA tensor runs the `ips_repack` kernel's tier
form on contiguous rows; of a CPU tensor, its plain version. Both equal
the reference bit for bit. The serving path does not call it: its fills
and repacks quantize straight from the hot tier into the dense tier
(`ips_repack.ops.quantize_into`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ips_repack import ops as repack_ops
from repro_torch.kernels.ips_repack.ref import INT4_MAX, dequantize_rows_ref

__all__ = ["INT4_MAX", "DENSITY_RATIO", "quantize_int4", "dequantize_int4",
           "quant_error_bound"]

DENSITY_RATIO = 4  # bf16 -> int4(+scales) ~= 4x tokens per byte


def quantize_int4(x, group: int = 64):
    """x: (..., F) with F % group == 0 -> (packed uint8 (..., F//2),
    scales float32 (..., F//group))."""
    f = x.shape[-1]
    assert f % group == 0 and group % 2 == 0, (f, group)
    rows = x.reshape(-1, f).contiguous()
    packed, scales = repack_ops.quantize_rows(rows, group)
    lead = x.shape[:-1]
    return packed.reshape(*lead, f // 2), scales.reshape(*lead, f // group)


def dequantize_int4(packed, scales, group: int = 64, dtype=torch.bfloat16):
    """Inverse of quantize_int4. packed: (..., F//2); scales:
    (..., F//group)."""
    half = packed.shape[-1]
    out = dequantize_rows_ref(packed.reshape(-1, half),
                              scales.reshape(-1, scales.shape[-1]), group,
                              dtype)
    return out.reshape(*packed.shape[:-1], half * 2)


def quant_error_bound(group: int = 64) -> float:
    """Max relative error of a symmetric int4 group: half an LSB step."""
    return 0.5 / INT4_MAX
