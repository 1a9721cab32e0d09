"""Plain PyTorch version of the in-place switch (bf16 -> int4 + scales).

The port of the reference's `repro/kernels/ips_repack/ref.py` and of the
quantizer it calls (`repro/core/tiercache/quant.py`), on any device:
symmetric groupwise int4, two nibbles per byte along the trailing
feature axis (value 2i low, 2i+1 high), one float32 scale per group of
`group` values, `q = round(x / max(scale, 1e-12))` half to even, clipped
to +-7, stored as q + 8.

The scale is `absmax * float32(1/7)`, not `absmax / 7`: that is what the
reference computes once compiled (XLA rewrites the division by the
constant into a product with its rounded reciprocal, under `jax.jit`
and in the Pallas kernel alike; only JAX's op-by-op dispatch divides).
The port follows the compiled reference, which is what its serving path
runs (ROADMAP §C; pinned by tests/test_torch_tiercache.py).
`quantize_into_ref` is the serving path's in-place form: the quantizer,
then the manager's `dynamic_update_slice` into the dense tier.

Arena byte layout per page (page = `tokens` cache entries of `feat`
bf16s):
  before: [tokens * feat * 2 bytes of bf16 data]
  after:  [tokens * feat / 2 bytes of packed int4
           | tokens * (feat/group) * 2 bytes of bf16 scales
           | unused tail = freed capacity, left as it was]
"""
from __future__ import annotations

import torch

__all__ = ["INT4_MAX", "INV_INT4_MAX", "page_layout", "quantize_rows_ref",
           "update_start", "quantize_into_ref", "dequantize_rows_ref", "repack_ref",
           "unpack_ref"]

INT4_MAX = 7.0
INV_INT4_MAX = 0.1428571492433548       # float32(1/7), exactly


def page_layout(tokens: int, feat: int, group: int):
    data_bytes = tokens * feat * 2
    packed_bytes = tokens * feat // 2
    scale_bytes = tokens * (feat // group) * 2
    assert packed_bytes + scale_bytes <= data_bytes
    return data_bytes, packed_bytes, scale_bytes


def quantize_rows_ref(x: torch.Tensor, group: int = 64):
    """x: (N, F) float -> (packed uint8 (N, F//2), scales float32
    (N, F//group))."""
    n, f = x.shape
    assert f % group == 0 and group % 2 == 0, (f, group)
    xg = x.to(torch.float32).reshape(n, f // group, group)
    scale = xg.abs().amax(dim=-1) * INV_INT4_MAX
    safe = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(xg / safe[..., None]), -INT4_MAX, INT4_MAX)
    q = (q + 8.0).to(torch.uint8).reshape(n, f)
    packed = q[:, 0::2] | (q[:, 1::2] << 4)
    return packed, scale


def update_start(start: int, size: int, length: int) -> int:
    """Where `jax.lax.dynamic_update_slice` writes `length` items into an
    axis of `size`: a negative start counted from the end, then clamped
    into [0, size - length]."""
    if length > size:
        raise ValueError(f"{length} tokens do not fit an axis of {size}")
    start = int(start)
    if start < 0:
        start += size
    return min(max(start, 0), size - length)


def quantize_into_ref(channels, start: int, group: int = 64) -> None:
    """The in-place tier form: for each (src, packed, scales) of
    `channels`, src (A, B, T, ..., F), the reference's
    `dynamic_update_slice(packed, quantize_int4(src)[0], (0, 0, start,
    ...))` and the same of the scales (cast to their dtype), written in
    place."""
    for src, packed, scales in channels:
        t, f = src.shape[2], src.shape[-1]
        s = update_start(start, packed.shape[2], t)
        pk, sc = quantize_rows_ref(src.reshape(-1, f), group)
        lead = src.shape[:-1]
        packed[:, :, s:s + t] = pk.reshape(*lead, f // 2)
        scales[:, :, s:s + t] = sc.reshape(*lead, f // group).to(scales.dtype)


def dequantize_rows_ref(packed: torch.Tensor, scales: torch.Tensor,
                        group: int = 64, dtype=torch.bfloat16):
    """Inverse of `quantize_rows_ref`: packed (N, F//2), scales
    (N, F//group) -> (N, F) in `dtype` (the product is float32)."""
    n, half = packed.shape
    f = half * 2
    lo = (packed & 0x0F).to(torch.int32) - 8
    hi = (packed >> 4).to(torch.int32) - 8
    q = torch.stack([lo, hi], dim=-1).reshape(n, f // group, group)
    x = q.to(torch.float32) * scales.to(torch.float32)[..., None]
    return x.reshape(n, f).to(dtype)


def repack_ref(arena_u8: torch.Tensor, tokens: int, feat: int,
               group: int = 64) -> torch.Tensor:
    """arena_u8: (pages, page_bytes) uint8 holding bf16 data. Returns a new
    arena with every page densified (the input is not changed)."""
    pages, page_bytes = arena_u8.shape
    data_bytes, packed_bytes, scale_bytes = page_layout(tokens, feat, group)
    assert page_bytes >= data_bytes
    vals = arena_u8[:, :data_bytes].contiguous().view(torch.bfloat16)
    packed, scales = quantize_rows_ref(vals.reshape(pages * tokens, feat),
                                       group)
    out = arena_u8.clone()
    out[:, :packed_bytes] = packed.reshape(pages, packed_bytes)
    out[:, packed_bytes:packed_bytes + scale_bytes] = (
        scales.to(torch.bfloat16).contiguous().view(torch.uint8)
        .reshape(pages, scale_bytes))
    return out


def unpack_ref(arena_u8: torch.Tensor, tokens: int, feat: int,
               group: int = 64, dtype=torch.bfloat16) -> torch.Tensor:
    """Read back a densified arena: (pages, tokens, feat) dequantized."""
    pages, _ = arena_u8.shape
    _, packed_bytes, scale_bytes = page_layout(tokens, feat, group)
    packed = arena_u8[:, :packed_bytes].reshape(pages * tokens, feat // 2)
    scales = (arena_u8[:, packed_bytes:packed_bytes + scale_bytes]
              .contiguous().view(torch.bfloat16)
              .reshape(pages * tokens, feat // group))
    return dequantize_rows_ref(packed, scales, group,
                               dtype).reshape(pages, tokens, feat)
